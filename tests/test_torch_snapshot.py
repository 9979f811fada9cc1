"""The port's snapshot formats against the JAX package's: the .ply writer
and readers, the reference-named decoder state dict (.pt) and the flat
.npz, the train-state checkpoint and the decoder snapshot (save, load), and
the slice as a whole: render_with_decoder on JAX weights carried across
against JAX render_with_decoder.

Copies are held bit for bit: PLY bytes, .pt and .npz keys and values, the
checkpoint's and the snapshot's tensors. The render: the JAX side decodes
through its XLA head chain and rasterizes with its 'xla' oracle, the port
through the K6 and K3 plain versions; decoded attributes within 1e-5 of
each attribute's largest magnitude, image within 1e-4 on 0.999 of the
pixels and PSNR >= 60 dB (f32 sums in another order)."""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.decoder.snapshot import render_with_decoder as jrender_with_decoder
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.gaussians import model as jmodel
from gaussian_gan_decoder_tpu.gaussians import ply as jply
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port.torch_export import decoder_state_dict, save_torch_state_dict
from gaussian_gan_decoder_tpu.train import checkpoint as jcheckpoint
from gaussian_gan_decoder_tpu_torch.apps.train_decoder import reference_state_dict
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.snapshot import (
    load_decoder, render_with_decoder, save_decoder)
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetSamplerConfig
from gaussian_gan_decoder_tpu_torch.gaussians import ply
from gaussian_gan_decoder_tpu_torch.gaussians.model import gaussian_scene_from_decoded
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_decoder_state
from gaussian_gan_decoder_tpu_torch.train import checkpoint
from gaussian_gan_decoder_tpu_torch.train.distill import DistillConfig, init_train_state
from _gan_parts import with_gan_parts
from _torch_threads import torch_threads  # noqa: F401  (autouse)

RK = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4,
      "c_gen_conditioning_zero": True}
GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=32, channel_base=512,
              channel_max=32)
IMG, M, FOV = 32, 2000, 0.227


@pytest.fixture(scope="module")
def models():
    """A JAX decoder (XLA head chain) with seeded weights of the generator
    parts the port holds, and the port decoder they load into."""
    with jax.enable_x64(False):
        jg = JGen(without_sr=True, rendering_kwargs=tuple(RK.items()), **GEN_KW)
        jd = JDec(generator=jg)

        def init():
            ks = jax.random.split(jax.random.PRNGKey(0), 3)
            gp = with_gan_parts(jg, {"backbone": jg.backbone.init(ks[0]),
                                     "decoder": jg.decoder.init(ks[1]),
                                     "torgb": jg.torgb.init(ks[2])})
            return jd.init(jax.random.PRNGKey(1), generator_params=gp)

        params = jax.jit(init)()
    dec = GaussianDecoder(TriPlaneGenerator(rendering_kwargs=RK, without_sr=True, **GEN_KW),
                          gelu="exact")
    load_decoder_state(dec, decoder_state_dict(jd, params))
    return jd, params, dec


def _decoded(seed, n):
    rng = np.random.RandomState(seed)
    return {"xyz": rng.randn(n, 3), "color": rng.randn(n, 3), "scale": rng.randn(n, 3) - 3,
            "rotation": rng.randn(n, 4), "opacity": rng.randn(n, 1)}


def test_ply_matches_jax(tmp_path):
    """save_ply writes the JAX writer's bytes for the same arrays;
    load_ply_arrays gives back the written values bit for bit; load_ply of a
    file with SH degree 1 (written by JAX) equals JAX load_ply."""
    dec = {k: v.astype(np.float32) for k, v in _decoded(0, 777).items()}
    ply.save_ply(gaussian_scene_from_decoded({k: torch.tensor(v) for k, v in dec.items()}),
                 str(tmp_path / "port.ply"))
    jply.save_ply(jmodel.gaussian_scene_from_decoded({k: jnp.asarray(v) for k, v in dec.items()}),
                  str(tmp_path / "jax.ply"))
    blob = (tmp_path / "port.ply").read_bytes()
    assert blob == (tmp_path / "jax.ply").read_bytes() and len(blob) > 777 * 17 * 4
    cols = ply.load_ply_arrays(str(tmp_path / "port.ply"))
    for k, name in (("x", ("xyz", 0)), ("f_dc_2", ("color", 2)), ("opacity", ("opacity", 0)),
                    ("scale_1", ("scale", 1)), ("rot_3", ("rotation", 3))):
        assert np.array_equal(cols[k], dec[name[0]][:, name[1]]), k

    rng = np.random.RandomState(1)
    n = 50
    f = lambda *s: jnp.asarray(rng.randn(*s).astype(np.float32))  # noqa: E731
    scene = jmodel.GaussianScene(f(n, 3), f(n, 1, 3), f(n, 3, 3), f(n, 3), f(n, 4), f(n, 1),
                                 jnp.ones((n,), bool), 1, 1)
    jply.save_ply(scene, str(tmp_path / "sh1.ply"))
    got, ref = ply.load_ply(str(tmp_path / "sh1.ply"), 1), jply.load_ply(str(tmp_path / "sh1.ply"), 1)
    for a, b in zip(got[:6], ref[:6]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert got.active_sh_degree == ref.active_sh_degree == 1


def test_pt_and_npz_match_jax(models, tmp_path):
    """The trainer's decoder<i>.pt (reference_state_dict) has the key set,
    shapes and values of JAX decoder_state_dict for the same weights, and
    loads back strictly; save_npz writes JAX save_npz's keys and values."""
    jd, params, dec = models
    ref = decoder_state_dict(jd, params)
    sd = reference_state_dict(dec)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32 and np.array_equal(sd[k].numpy(), v), k
    torch.save(sd, tmp_path / "port.pt")
    back = torch.load(tmp_path / "port.pt", weights_only=True)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    # the JAX writer stores 0-d tensors (noise_strength) with shape (1,)
    # (np.ascontiguousarray); load_decoder_state takes both files
    save_torch_state_dict(str(tmp_path / "jax.pt"), ref)
    for path in ("port.pt", "jax.pt"):
        fresh = copy.deepcopy(dec)
        for p in fresh.parameters():
            p.data.zero_()
        load_decoder_state(fresh, str(tmp_path / path))
        assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                      dec.state_dict().values())), path

    checkpoint.save_npz(str(tmp_path / "port.npz"), dec.state_dict())
    jcheckpoint.save_npz(str(tmp_path / "jax.npz"), params)
    a, b = checkpoint.load_npz(str(tmp_path / "port.npz")), jcheckpoint.load_npz(
        str(tmp_path / "jax.npz"))
    assert set(a) == set(b) and len(a) == len(ref)
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_train_state_checkpoint_round_trip(models, tmp_path):
    """checkpoint.save / restore of a train state after two Adam steps:
    every parameter, buffer, Adam moment and the step come back bit for bit
    into a fresh state; the configs come back equal (and hashable)."""
    _, _, dec = models
    dec = copy.deepcopy(dec)
    cfg = DistillConfig(image_size=IMG, bg_color=(0.1, 0.2, 0.3))
    state = init_train_state(dec, copy.deepcopy(dec.G), cfg)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        for p in dec.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        state.optimizer.step()
        state.step += 1
    tcfg = TargetSamplerConfig(shape_res=16, num_points=M)
    configs = {"decoder": dec.config, "target_cfg": tcfg, "distill_cfg": cfg}
    checkpoint.save(str(tmp_path / "state"), state, configs)

    fresh = GaussianDecoder.from_config(dec.config)
    restored = checkpoint.restore(str(tmp_path / "state"),
                                  init_train_state(fresh, copy.deepcopy(fresh.G), cfg))
    assert restored.step == 2
    for (n, a), b in zip(dec.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n
    s0, s1 = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert s0["param_groups"] == s1["param_groups"] and len(s0["state"]) > 100
    for i, st in s0["state"].items():
        for k, v in st.items():
            assert torch.equal(v, s1["state"][i][k]), (i, k)
    back = checkpoint.load_configs(str(tmp_path / "state"))
    assert back == configs and hash(back["decoder"]) == hash(dec.config)


def test_snapshot_round_trip_and_render_match_jax(models, tmp_path):
    """save_decoder / load_decoder: the decoder's and the frozen generator's
    state bit for bit, rebuilt from the JSON config; then
    render_with_decoder of the loaded decoder against JAX's on the same
    latent, camera and surface points."""
    jd, params, dec = models
    frozen = copy.deepcopy(dec.G)
    tcfg = TargetSamplerConfig(shape_res=16, num_points=M)
    save_decoder(str(tmp_path / "snap"), dec, frozen, target_cfg=tcfg,
                 extra_configs={"distill_cfg": DistillConfig()})
    loaded, configs = load_decoder(str(tmp_path / "snap"), device="cpu")
    assert configs["target_cfg"] == tcfg and configs["decoder"] == dec.config
    assert loaded.gelu == "exact" and loaded.G.config == dec.G.config
    for (n, a), b in zip(dec.state_dict().items(), loaded.state_dict().values()):
        assert torch.equal(a, b), n
    for (n, a), b in zip(frozen.state_dict().items(), configs["frozen_G"].state_dict().values()):
        assert torch.equal(a, b), n
    assert os.path.exists(str(tmp_path / "snap") + ".config.json")

    rng = np.random.RandomState(2)
    z = rng.randn(1, 32).astype(np.float32)
    verts = ((rng.rand(M, 3) - 0.5) * 0.4).astype(np.float32)
    cp, c2w = jcam_params()
    with jax.enable_x64(False):
        jimg, jdec = jrender_with_decoder(jd, params, jnp.asarray(z), cp, c2w,
                                          jnp.asarray(verts), FOV, image_size=IMG)
        jimg, jdec = np.asarray(jimg), {k: np.asarray(v) for k, v in jdec.items()}
    img, decoded = render_with_decoder(loaded, torch.tensor(z), torch.tensor(np.asarray(cp)),
                                       np.asarray(c2w), torch.tensor(verts), FOV, image_size=IMG)
    for name, ref in jdec.items():
        err = np.abs(decoded[name].numpy() - ref).max() / np.abs(ref).max()
        print(f"decoded {name}: {err:.3e} of its max")
        assert decoded[name].shape == ref.shape and err <= 1e-5, name
    d = np.abs(img.numpy() - jimg)
    psnr = 10 * np.log10(1.0 / max(float(np.mean(d ** 2)), 1e-30))
    print(f"render_with_decoder vs JAX: max |d| {d.max():.3e}, PSNR {psnr:.1f} dB")
    assert img.shape == (3, IMG, IMG) and jimg.std() > 0.01
    assert (d <= 1e-4).mean() >= 0.999 and psnr >= 60.0


def test_decoder_pallas_mapping_matches_jax(models, tmp_path):
    """The decoder's pallas_mapping option: apply maps through the fused
    mapping (bf16 weights; the JAX package's mapping_forward_pallas in
    interpret mode, the port's K1 wrapper, whose plain version runs here),
    as JAX's apply does. Every decoded attribute within 1e-4 of its largest
    magnitude; the route is the fused one (the f32 mapping's attributes
    differ), the option survives a snapshot, and a backward through it
    raises, as the JAX kernel has no VJP."""
    jd, params, dec = models
    jdm = dataclasses.replace(jd, pallas_mapping=True)
    decm = copy.deepcopy(dec)
    decm.config = dataclasses.replace(dec.config, pallas_mapping=True)
    rng = np.random.RandomState(10)
    z = rng.randn(1, 32).astype(np.float32)
    pos = ((rng.rand(400, 3) - 0.5) * 0.4).astype(np.float32)
    cp = np.asarray(jcam_params()[0], np.float32)
    with jax.enable_x64(False):
        ref = jax.jit(lambda p, z, c, x: jdm.apply(p, z, c, x, truncation_psi=0.7))(
            params, jnp.asarray(z), jnp.asarray(cp), jnp.asarray(pos))
        ref = {k: np.asarray(v) for k, v in ref.items()}
    args = (torch.tensor(z), torch.tensor(cp), torch.tensor(pos))
    with torch.no_grad():
        got = decm.apply(*args, truncation_psi=0.7)
        f32 = dec.apply(*args, truncation_psi=0.7)
    assert list(got) == list(ref)
    for k, want in ref.items():
        err = np.abs(got[k].numpy() - want).max() / np.abs(want).max()
        print(f"pallas_mapping apply {k}: {err:.3e} of its max")
        assert got[k].shape == want.shape and err <= 1e-4, (k, err)
    assert any(not torch.equal(got[k], f32[k]) for k in got)

    save_decoder(str(tmp_path / "snap"), decm)
    loaded, _ = load_decoder(str(tmp_path / "snap"), device="cpu")
    assert loaded.config == decm.config and loaded.pallas_mapping
    out = decm.apply(*args, truncation_psi=0.7)
    with pytest.raises(RuntimeError, match="no gradient"):
        sum(v.sum() for v in out.values()).backward()

