"""Port parity of GaussianDecoder's types and options against the JAX
package: the three decoder types with and without the xyz embedding,
hidden width 64 on the plain chain, the inference entries decode_packed /
apply_packed / apply_project at either dtype, the 'sequential' type's
camera at the mapping, and the decoder snapshots and reference pickles of
every type. Small shapes: the JAX CLI's --smoke generator (z/w 32, 16^2
tri-grid of depth 3), M = 300 template points, random planes or weights
drawn with numpy / the JAX init; JAX's Pallas kernels run in interpret
mode, the port's kernels take their plain versions.

Tolerances. decode_from_planes' attributes within 1e-4 of each
attribute's largest value (the f32 chain summed in another order), 5e-2 on
the bf16 chain (the JAX bf16 tests' limit); the
gradients of apply (heads and the G copy, through synthesis and the
sample) within 1e-4 of each tensor's own largest gradient; the plain
hidden-64 chain within 1e-5 and its head gradients within 1e-4.
decode_packed and decode_project on the same planes: rows 0:14 within
1e-4 of each row's scale at f32, 5e-2 at bf16 (the JAX bf16 tests'
limit); apply_packed / apply_project, which add the fused mapping (bf16
weights, sums in another order) and synthesis, at K2's tolerances
(test_torch_decode_project.py). The mapping camera: the port's K1 input
equals JAX's bit for bit; ws within 1e-2 of the mean |ws| (the fused
mapping's limit, test_torch_mapping.py). Snapshots and pickles: bits."""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.models import pallas_mapping as jpallas_mapping
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port import torch_pickle as jpickle
from gaussian_gan_decoder_tpu.port.torch_export import (
    decoder_state_dict, generator_state_from_params)
from gaussian_gan_decoder_tpu_torch.apps import render_decoder
from gaussian_gan_decoder_tpu_torch.decoder import heads as theads
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.snapshot import load_decoder, save_decoder
from gaussian_gan_decoder_tpu_torch.decoder.surface import sigma_grid_separable
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetSamplerConfig
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.port import torch_pickle
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_decoder_state, load_generator_state
from test_torch_decode_project import _k2_tolerances
from test_torch_pickle import INIT_ARGS, INIT_KW, _dumps, _generator_flat, _modules
from _torch_threads import torch_threads  # noqa: F401  (autouse)

RK = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4}
GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=32, channel_base=512,
              channel_max=32, num_fp16_res=0)
M, IMG, FOV = 300, 64, 0.227
TYPES = ("sequential_reversed", "sequential", "parallel")


def _gen_params(jg, seed):
    with jax.enable_x64(False):
        def init():
            ks = jax.random.split(jax.random.PRNGKey(seed), 3)
            return {"backbone": jg.backbone.init(ks[0]), "decoder": jg.decoder.init(ks[1]),
                    "torgb": jg.torgb.init(ks[2])}
        return jax.jit(init)()


@pytest.fixture(scope="module")
def base():
    """The smoke generator in both packages with the same weights, a
    template, random planes, a real camera and a random latent."""
    jg = JGen(without_sr=True, rendering_kwargs=tuple(RK.items()), **GEN_KW)
    gp = _gen_params(jg, 0)
    gen = TriPlaneGenerator(rendering_kwargs=RK, without_sr=True, **GEN_KW)
    load_generator_state(gen, generator_state_from_params(gp))
    rng = np.random.RandomState(51)
    _, c2w = jcam_params()
    cp = np.concatenate([np.asarray(c2w).reshape(-1), rng.rand(9).astype(np.float32)])[None]
    return dict(jg=jg, gp=gp, gen=gen, cp=cp.astype(np.float32),
                pos=((rng.rand(M, 3) - 0.5) * 0.5).astype(np.float32),
                planes=rng.randn(1, 3, 96, 16, 16).astype(np.float32),
                z=rng.randn(1, 32).astype(np.float32),
                jcam=jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), c2w),
                cam=make_camera(IMG, FOV, np.asarray(c2w)))


def _pair(b, decoder_type, emb, seed, hidden=128, gelu="exact", **jkw):
    """JAX decoder + params (heads from the JAX init, G the base weights)
    and the port decoder loaded from them."""
    jd = JDec(generator=b["jg"], decoder_type=decoder_type, use_xyz_embedding=emb,
              hidden_dim=hidden, gelu=gelu, **jkw)
    with jax.enable_x64(False):
        params = jax.jit(lambda k: jd.init(k, generator_params=b["gp"]))(
            jax.random.PRNGKey(seed))
    td = GaussianDecoder(copy.deepcopy(b["gen"]), gelu=gelu, decoder_type=decoder_type,
                         use_xyz_embedding=emb, hidden_dim=hidden,
                         fused_lerp=jkw.get("fused_lerp", "dots"),
                         **{k: jkw.get(k, False)
                            for k in ("heads_bf16", "pallas_heads", "pallas_heads_train")})
    load_decoder_state(td, decoder_state_dict(jd, params))
    return jd, params, td


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def test_decode_from_planes_matches_jax(base):
    """decode_from_planes of every type with and without the embedding
    (JAX: the custom-VJP Pallas chain, pallas_heads_train; the port: its
    plain version), the bf16 chain alone (pallas_heads, heads_bf16), and
    hidden 64 on the plain chain of both, with its head gradients against
    jax.grad."""
    b = base
    planes, pos = jnp.asarray(b["planes"]), jnp.asarray(b["pos"])
    for k, decoder_type in enumerate(TYPES):
        for emb in (False, True):
            jd, params, td = _pair(b, decoder_type, emb, 60 + k, pallas_heads_train=True)
            ref = jd.decode_from_planes(params, planes, pos)
            out = td.decode_from_planes(torch.tensor(b["planes"]), torch.tensor(b["pos"]))
            assert list(out) == [n for n, _ in td.chain_spec]
            for name, v in out.items():
                assert _rel(v.detach(), ref[name]) <= 1e-4, (decoder_type, emb, name)
    # the bf16 chain alone (pallas_heads with heads_bf16, K6's bf16 form): the
    # JAX bf16 tests' limit, 5e-2 of each attribute's scale
    # a backward through it raises, as differentiating the JAX kernel does
    jd, params, td = _pair(b, "sequential", True, 67, gelu="poly", pallas_heads=True,
                           heads_bf16=True)
    ref = jd.decode_from_planes(params, planes, pos)
    out = td.decode_from_planes(torch.tensor(b["planes"]), torch.tensor(b["pos"]))
    for name, v in out.items():
        assert _rel(v.detach(), ref[name]) <= 5e-2, name
    with pytest.raises(RuntimeError, match="no gradient"):
        sum(v.sum() for v in out.values()).backward()
    jd, params, td = _pair(b, "parallel", True, 66, hidden=64, pallas_heads_train=True)
    w = {n: np.random.RandomState(i).randn(M, d).astype(np.float32)
         for i, (n, d) in enumerate(td.chain_spec)}

    def jloss(p):
        out = jd.decode_from_planes(p, planes, pos)
        return sum(jnp.sum(out[n] * w[n]) for n in w)

    with jax.enable_x64(False):
        jgrads = decoder_state_dict(jd, jax.grad(jloss)(params))
    out = td.decode_from_planes(torch.tensor(b["planes"]), torch.tensor(b["pos"]))
    ref = jd.decode_from_planes(params, planes, pos)
    for name, v in out.items():
        assert _rel(v.detach(), ref[name]) <= 1e-5, name
    sum((out[n] * torch.tensor(w[n])).sum() for n in w).backward()
    for name, p in td.named_parameters():
        if not name.startswith("G."):
            assert _rel(p.grad, jgrads[name]) <= 1e-4, name


def test_apply_gradients_match_jax(base):
    """apply (the G copy's f32 mapping on the type's camera, synthesis, the
    sample and the kernel chain) and the gradient of a fixed linear
    function of its outputs with respect to every head and G tensor,
    against jax.grad: D-par's options, and 'sequential', whose mapping sees
    the real camera."""
    b = base
    z, cp, pos = jnp.asarray(b["z"]), jnp.asarray(b["cp"]), jnp.asarray(b["pos"])
    for decoder_type, emb in (("parallel", True), ("sequential", False)):
        jd, params, td = _pair(b, decoder_type, emb, 70, pallas_heads_train=True)
        w = {n: np.random.RandomState(i + 3).randn(M, d).astype(np.float32)
             for i, (n, d) in enumerate(td.chain_spec)}

        def jloss(p, jd=jd, w=w):
            out = jd.apply(p, z, cp, pos)
            return sum(jnp.sum(out[n] * w[n]) for n in w)

        with jax.enable_x64(False):
            jval, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
        ref = decoder_state_dict(jd, jgrads)
        out = td.apply(torch.tensor(b["z"]), torch.tensor(b["cp"]), torch.tensor(b["pos"]))
        loss = sum((out[n] * torch.tensor(w[n])).sum() for n in w)
        assert abs(float(loss.detach()) - float(jval)) <= 1e-4 * abs(float(jval))
        loss.backward()
        n_checked = 0
        for name, p in td.named_parameters():
            if name.startswith(("G.decoder.", "G.torgb.")):
                continue   # not on the decode path: zero on both sides
            g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            if np.abs(ref[name]).max() > 0:
                n_checked += 1
            assert _rel(g, ref[name]) <= 1e-4, (decoder_type, name, _rel(g, ref[name]))
        assert n_checked >= 60


def test_sequential_mapping_camera_matches_jax(base, monkeypatch):
    """The inference synthesize_planes hands the fused mapping (K1) what the
    JAX package hands its fused mapping: for 'sequential' the real camera
    through the generator's conditioning rule (c * c_scale; zeros under
    c_gen_conditioning_zero), for the other types zeros; the ws agree."""
    b = base
    seen = {}
    jfn = jpallas_mapping.mapping_forward_pallas

    def jspy(mn, p, z, c, psi=1.0):
        seen["jax"] = np.asarray(c)
        return jfn(mn, p, z, c, psi)

    monkeypatch.setattr(jpallas_mapping, "mapping_forward_pallas", jspy)
    tfn = theads.mapping_forward

    def tspy(z, c, fm, psi=1.0):
        seen["port"] = c.numpy().copy()
        return tfn(z, c, fm, psi)

    monkeypatch.setattr(theads, "mapping_forward", tspy)
    z, cp = jnp.asarray(b["z"]), jnp.asarray(b["cp"])
    for decoder_type, cgcz, scale in (("sequential", False, 1.0), ("sequential", False, 0.5),
                                      ("sequential", True, 1.0), ("parallel", False, 1.0)):
        rk = dict(RK, c_gen_conditioning_zero=cgcz, c_scale=scale)
        jg = JGen(without_sr=True, rendering_kwargs=tuple(rk.items()), **GEN_KW)
        jd = JDec(generator=jg, decoder_type=decoder_type, pallas_mapping=True)
        params = {"G": b["gp"]}
        gen = TriPlaneGenerator(rendering_kwargs=rk, without_sr=True, **GEN_KW)
        gen.load_state_dict(b["gen"].state_dict())
        td = GaussianDecoder(gen, decoder_type=decoder_type)
        _, jws = jd.synthesize_planes(params, z, cp)
        _, ws = td.synthesize_planes(td.fold(), torch.tensor(b["z"]), torch.tensor(b["cp"]))
        want = (np.zeros_like(b["cp"]) if cgcz or decoder_type != "sequential"
                else b["cp"] * np.float32(scale))
        np.testing.assert_array_equal(seen["jax"], want)
        np.testing.assert_array_equal(seen["port"], want)
        jws = np.asarray(jws)
        err = np.abs(ws.numpy() - jws).max() / np.abs(jws).mean()
        assert err <= 1e-2, (decoder_type, cgcz, scale, err)


def test_packed_and_project_match_jax(base):
    """decode_packed and decode_project (table and fused routes) on the same
    planes at f32 (D-par) and bf16 (D-seq), then apply_packed and
    apply_project from a latent, against the JAX decoder with int8 bricks,
    the fused mapping and the 'bcast' lerp."""
    b = base
    planes, pos = jnp.asarray(b["planes"]), jnp.asarray(b["pos"])
    tplanes, tpos = torch.tensor(b["planes"]), torch.tensor(b["pos"])
    for k, (decoder_type, emb, bf16, gelu) in enumerate(
            (("parallel", True, False, "exact"), ("sequential", False, True, "poly"))):
        jd, params, td = _pair(b, decoder_type, emb, 80 + k, gelu=gelu, heads_bf16=bf16,
                               int8_sampling=True, pallas_heads=True, pallas_mapping=True,
                               fused_lerp="bcast")
        w = td.fold()
        assert w.chain.w1.dtype == (torch.bfloat16 if bf16 else torch.float32)
        lim = 5e-2 if bf16 else 1e-4
        jout, jlayout = jd.decode_packed(params, planes, pos)
        out, layout = td.decode_packed(w, tplanes, tpos)
        assert layout == dict(jlayout) and out.shape == jout.shape
        ref = np.asarray(jout)[:M, :14]
        err = (np.abs(out.numpy()[:M, :14] - ref) / np.maximum(np.abs(ref).max(0), 1e-3)).max()
        assert err <= lim, ("decode_packed", decoder_type, err)
        for fused in (False, True):
            jd_r = dataclasses.replace(jd, fused_sampling=fused)
            td.config = dataclasses.replace(td.config, fused_sampling=fused)
            jrows, _ = jd_r.decode_project(params, planes, pos, b["jcam"])
            rows, _ = td.decode_project(w, tplanes, b["cam"], init_position=tpos)
            jr, r = np.asarray(jrows), rows.numpy()
            err = (np.abs(r[:14, :M] - jr[:14, :M])
                   / np.maximum(np.abs(jr[:14, :M]).max(1, keepdims=True), 1e-3)).max()
            assert err <= lim, ("decode_project", decoder_type, fused, err)
        td.config = dataclasses.replace(td.config, fused_sampling=False)
        z, cp = jnp.asarray(b["z"]), jnp.asarray(b["cp"])
        jout, _ = jd.apply_packed(params, z, cp, pos)
        out, _ = td.apply_packed(w, torch.tensor(b["z"]), torch.tensor(b["cp"]), tpos)
        ref = np.asarray(jout)[:M, :14]
        assert (np.abs(out.numpy()[:M, :14] - ref)
                / np.maximum(np.abs(ref).max(0), 1e-3)).max() < 5e-2
        jrows, _ = jd.apply_project(params, z, cp, pos, b["jcam"])
        rows, _ = td.apply_project(w, torch.tensor(b["z"]), torch.tensor(b["cp"]), tpos,
                                   b["cam"])
        _k2_tolerances(rows.numpy(), np.asarray(jrows), f"apply_project {decoder_type}")


def test_snapshot_and_reference_pickles(base, tmp_path):
    """D-par's snapshot round trip (config and bits); a reference-style
    ParallelDecoder pickle with the embedding and hidden 64 loads strictly,
    as the JAX loader reads it; one that records no use_xyz_embedding reads
    it as True (the reference's default); the loaded decoder's snapshot
    renders through the render app."""
    b = base
    _, _, td = _pair(b, "parallel", True, 90, heads_bf16=False)
    path = str(tmp_path / "dpar")
    save_decoder(path, td, b["gen"])
    loaded, configs = load_decoder(path, device="cpu")
    assert loaded.config == td.config and not loaded.heads_bf16
    assert loaded.decoder_type == "parallel" and loaded.position_dim == 63
    assert all(torch.equal(v, td.state_dict()[k]) for k, v in loaded.state_dict().items())

    gen, flat = _generator_flat()
    g = _modules(flat, class_name="TriPlaneGenerator", init_args=INIT_ARGS, init_kwargs=INIT_KW)
    for emb_recorded in (True, None):
        dec = GaussianDecoder(gen, gelu="exact", rng=torch.Generator().manual_seed(3),
                              decoder_type="parallel", use_xyz_embedding=True, hidden_dim=64)
        heads = {k: v for k, v in dec.state_dict().items() if not k.startswith("G.")}
        extra = {"hidden_dim": 64, "use_gen_finetune": True}
        if emb_recorded:
            extra["use_xyz_embedding"] = True
        dstub = _modules(heads, class_name="ParallelDecoder", extra=extra)
        dstub.modules["G"] = g
        pkl = tmp_path / f"parallel_{emb_recorded}.pkl"
        pkl.write_bytes(_dumps({"decoder": dstub, "dataloader": None}))
        got, state = torch_pickle.load_decoder_pkl(str(pkl), device="cpu")
        assert (got.decoder_type, got.hidden_dim, got.use_xyz_embedding) == ("parallel", 64, True)
        jcfg, jparams = jpickle.load_decoder_pkl(str(pkl))
        assert (jcfg.decoder_type, jcfg.hidden_dim, jcfg.use_xyz_embedding) == (
            "parallel", 64, True)
        ref = decoder_state_dict(jcfg, jparams)
        assert set(state) == set(ref)
        assert all(np.array_equal(state[k], v) for k, v in ref.items())
        assert all(torch.equal(v, dec.state_dict()[k]) for k, v in got.state_dict().items()
                   if not k.startswith("G."))
    # the loaded decoder renders through apps/render_decoder.py from its
    # snapshot (surface level: the 0.9 quantile of the render's latent's
    # sigma grid, as a random field has no meaningful iso-level)
    z = torch.randn((1, 32), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        sig = sigma_grid_separable(got.G, got.G.synthesis_planes(got.G.mapping(
            z, torch.zeros(1, 25))), shape_res=16)
    tcfg = TargetSamplerConfig(shape_res=16, num_points=256, face_capacity=12 * 15 ** 3,
                               mc_level=float(torch.quantile(sig.flatten(), 0.9)))
    snap = str(tmp_path / "parallel_snapshot")
    save_decoder(snap, got, got.G, target_cfg=tcfg)
    out = render_decoder.main(["--checkpoint", snap, "--seed", "7", "--image_size", "32",
                               "--out", str(tmp_path / "r.png"), "--force_cpu"])
    assert os.path.getsize(out["image"]) > 0
