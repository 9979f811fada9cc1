"""Port parity of the EG3D tri-plane generator's frame and distillation step
vs the JAX package: render_planes (no ToRGB, no background, no mask; the
SR stack's raw-image alias), the decode-and-render frame on the slab, table
and fused routes, the train step's loss and every gradient (the JAX CLI's
--smoke EG3D generator, the eg3d_ffhq preset's cameras and background),
the weight loaders (from_jax and reference pickles, strictly), and the
trainer's --generator_arch eg3d_ffhq run with its snapshot and the render
and eval apps on it. The JAX side runs in float32 (x64 off, as its CLI
runs) with its Pallas kernels in interpret mode; the port on the CPU takes
the kernels' plain versions. Weights are the port's seeded init, carried to
the JAX side through its pickle importer's re-nesting
(generator_params_from_state), and the JAX functions run under jax.jit
(eagerly, the JAX step alone took 104 s of this file's time on the CPU).

Tolerances, stated per test: render_planes' images within 1e-4 of their
max (tests/test_torch_target.py's); frames at PSNR >= 30 dB and decoded
attributes within 5e-2 of each attribute's max (the slab frame's,
tests/test_torch_flagship.py); the step's loss and metrics within 1e-4
(relative) and every gradient within 2e-3 of its tensor's own largest
gradient (tests/test_torch_train_step.py's, with the port's LPIPS term in
float64 for the reason given there); weights bit for bit."""
import contextlib
import copy
import dataclasses
import json
import math
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.decoder.target_pipeline import TargetSamplerConfig as JTCfg
from gaussian_gan_decoder_tpu.flagship import decode_and_render as jdecode_and_render
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.flagship import flagship_raster_config as jraster_config
from gaussian_gan_decoder_tpu.losses.lpips import VGG16LPIPS as JVGG
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port import torch_pickle as jpickle
from gaussian_gan_decoder_tpu.port.torch_export import (
    decoder_state_dict, generator_state_from_params)
from gaussian_gan_decoder_tpu.splat.rasterize import RasterizeConfig as JRCfg
from gaussian_gan_decoder_tpu.train.distill import DistillConfig as JDCfg
from gaussian_gan_decoder_tpu.train.distill import make_loss_fn as jmake_loss_fn
from gaussian_gan_decoder_tpu_torch import flagship
from gaussian_gan_decoder_tpu_torch.apps import eval_decoder, render_decoder, train_decoder
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.snapshot import load_decoder
from gaussian_gan_decoder_tpu_torch.decoder.surface import sigma_grid_separable
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetSamplerConfig
from gaussian_gan_decoder_tpu_torch.losses import VGG16LPIPS, lpips_loss
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import RenderDraws
from gaussian_gan_decoder_tpu_torch.port import torch_pickle
from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig
from gaussian_gan_decoder_tpu_torch.port.from_jax import (
    load_decoder_state, load_generator_state, load_vgg16_lpips_state)
from gaussian_gan_decoder_tpu_torch.train import distill
from gaussian_gan_decoder_tpu_torch.train.distill import DistillConfig, make_loss_fn

from test_torch_losses import vgg_state
from test_torch_pickle import _modules, _persistence_shim
from test_torch_slab_decode import head_params
from test_torch_train_step import HEADS, _t
from _torch_threads import torch_threads  # noqa: F401  (autouse)

DEF = jnp.float32   # jax.random's default float type with x64 off
BG = (0.0, 0.0, 0.0)  # the eg3d presets' background
# the JAX CLI's --smoke generator (apps/train_decoder.py), EG3D
SMOKE_RK = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4,
            "c_gen_conditioning_zero": True}
SMOKE_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=32, channel_base=512,
                channel_max=32)
IMG, POINTS, RES = 32, 1024, 16
LEVEL_QUANTILE = 0.9   # the step's marching level: this quantile of its latent's sigma grid
# tests/test_models_triplane.py::tiny_generator("eg3d"), for the frames
TINY_RK = {"triplane_size": 32, "depth_resolution": 8, "depth_resolution_importance": 8,
           "c_gen_conditioning_zero": True}
TINY_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, channel_base=1024,
               channel_max=64, without_sr=True)
M, BLOCK, FRAME, FOV = 1000, 256, 64, 0.227


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _generators(rk, kw, seed):
    """An EG3D generator pair with the port's seeded weights, the density
    bias raised (a denser field, as in tests/test_torch_target.py) -> (JAX
    generator, its params, port generator, the reference-named state)."""
    tg = TriPlaneGenerator(variant="eg3d", rendering_kwargs=rk, **kw,
                           generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        tg.decoder.net[2].bias[0] = 0.3
    flat = {k: v.numpy().copy() for k, v in tg.state_dict().items()}
    jg = JGen(variant="eg3d", rendering_kwargs=tuple(rk.items()), **kw)
    return jg, jax.tree_util.tree_map(jnp.asarray, jpickle.generator_params_from_state(flat)), \
        tg, flat


@pytest.fixture(scope="module")
def sr_generators():
    """With the 2x SR stack (w 512, 16^2 tri-planes, a 128^2 image): the
    reference EG3D generators all have one."""
    rk = dict(SMOKE_RK, superresolution_module="training.superresolution.SuperresolutionHybrid2X")
    return _generators(rk, dict(SMOKE_KW, w_dim=512, img_resolution=128), 0)


def test_render_planes_matches_jax(sr_generators):
    """EG3D render_planes at 64^2 into the 2x SR stack (block0's ToRGB skip
    lands in image_raw, the reference's in-place alias): image_raw,
    image_depth and image within 1e-4 of their max; no image_mask on
    either side."""
    jg, params, tg, _ = sr_generators
    assert tg.torgb is None and tg.triplane_depth == 1
    res = 64
    z = np.random.RandomState(1).randn(1, 32).astype(np.float32)
    cp, _ = jcam_params()
    key = jax.random.PRNGKey(2)

    @jax.jit
    def jrender(p, zz):
        ws = jg.mapping(p, zz, jnp.zeros((1, 25), DEF))
        planes = jg.synthesis_planes(p, ws, noise_mode="const")
        return planes, ws, jg.render_planes(p, planes, ws, cp, neural_rendering_resolution=res,
                                            key=key)

    planes, ws, ref = jrender(params, jnp.asarray(z))
    k_strat, k_imp = jax.random.split(key)
    draws = RenderDraws(_t(jax.random.uniform(k_strat, (1, res * res, 4, 1), DEF)),
                        _t(jax.random.uniform(k_imp, (res * res, 4), DEF)))
    with torch.no_grad():
        out = tg.render_planes(_t(planes), _t(ws), _t(cp), draws,
                               neural_rendering_resolution=res)
    assert "image_mask" not in out and "image_mask" not in ref
    for k in ("image_raw", "image_depth", "image"):
        err = _rel(out[k], ref[k])
        print(f"EG3D render_planes {k}: {err:.3e}")
        assert err <= 1e-4, (k, err)
    assert float(out["image_raw"].std()) > 0


def _decoders(jg, gparams, tg, gelu, seed, **jkw):
    """The JAX decoder (heads drawn with numpy, the generator's params as
    its G) and the port's with the same weights -> (jd, params, td, the
    reference-named state)."""
    jd = JDec(generator=jg, decoder_type="sequential_reversed", gelu=gelu, **jkw)
    params = dict(head_params(jd, seed), G=gparams)
    sd = decoder_state_dict(jd, params)
    td = GaussianDecoder(copy.deepcopy(tg), gelu=gelu,
                         **{k: jkw.get(k, False)
                            for k in ("heads_bf16", "pallas_heads", "pallas_heads_train")})
    load_decoder_state(td, sd)
    return jd, params, td, sd


@pytest.fixture(scope="module")
def frame_models():
    jg, gparams, tg, _ = _generators(TINY_RK, TINY_KW, 1)
    return _decoders(jg, gparams, tg, "poly", 0, int8_sampling=True, pallas_heads=True,
                     heads_bf16=True, pallas_mapping=True)


@pytest.mark.parametrize("route", ["slab", "table", "fused"])
def test_eg3d_frame_matches_jax(frame_models, route):
    """latent -> tri-planes -> decode -> binning -> blend on one route
    (slab: the bilinear pack and K2's bilinear form; table: the bf16
    bilinear table, the plane mean and K8; fused: the bf16 gathers and
    K9's tri-plane form, JAX's 'bcast' lerp), the eg3d background, f32
    raster payloads on the JAX side; 1000 template points."""
    jd, params, td, _ = frame_models
    rng = np.random.RandomState(5)
    pos = ((rng.rand(M, 3) - 0.5) * 0.4).astype(np.float32)
    z = rng.randn(1, 32).astype(np.float32)
    cp, c2w = jcam_params()
    cfg = dataclasses.replace(jraster_config(), packed_payloads=False, bf16_colors=False,
                              fused_sort_key=False, rgb10_payloads=False,
                              static_copies=4, overflow_budget=8192)
    jdr = dataclasses.replace(jd, slab_sampling=route == "slab",
                              fused_sampling=route == "fused", fused_lerp="bcast")
    jctx = jdr.make_slab_context(pos, block=BLOCK) if route == "slab" else None
    jimg, jdec, jaux = jax.jit(lambda p, zz: jdecode_and_render(
        jdr, p, zz, cp, c2w, jnp.asarray(pos), FOV, image_size=FRAME, bg=BG, raster_cfg=cfg,
        backend="pallas", return_aux=True, slab_ctx=jctx))(params, jnp.asarray(z))
    assert int(jaux["n_dropped"]) == 0

    dec = GaussianDecoder(td.G, gelu="poly", fused_sampling=route == "fused",
                          pallas_heads=True, heads_bf16=True, fused_lerp="bcast")
    dec.load_state_dict(td.state_dict())
    tcp, tc2w = flagship.default_camera_params(device="cpu")
    ctx = dec.make_slab_context(pos, block=BLOCK) if route == "slab" else None
    img, decoded, aux = flagship.decode_and_render(
        dec, dec.fold(), torch.tensor(z), tcp, tc2w, ctx, FOV, image_size=FRAME, bg=BG,
        return_aux=True, init_position=torch.tensor(pos),
        raster_cfg=RasterizeConfig(tile_capacity=cfg.tile_capacity))
    img, jimg = img.numpy(), np.asarray(jimg)
    assert img.shape == jimg.shape == (3, FRAME, FRAME) and np.isfinite(img).all()
    assert jimg.max() > 0.1 and img.std() > 0
    psnr = 10 * np.log10(1.0 / np.mean((img - jimg) ** 2))
    print(f"EG3D {route} frame port vs JAX: {psnr:.2f} dB")
    assert psnr >= 30.0, psnr
    for name, ref in jdec.items():
        ref = np.asarray(ref)
        err = np.abs(decoded[name].numpy() - ref).max() / np.abs(ref).max()
        assert decoded[name].shape == ref.shape and err <= 5e-2, (name, err)
    assert aux["n_dropped"] == 0
    agree = (aux["visibility_filter"].numpy() == np.asarray(jaux["visibility_filter"])).mean()
    assert agree >= 0.995, agree


def _cfgs(level):
    """The eg3d_ffhq preset's cameras (stddevs 0.2, 0.2) and background, at
    the JAX CLI's --smoke sizes."""
    common = dict(camera_sampling="normal", init_truncation=1.0, truncation_ramp=20_000,
                  vertical_stddev=0.2, horizontal_stddev=0.2, shape_res=RES,
                  num_points=POINTS, mc_level=level, face_capacity=12 * (RES - 1) ** 3,
                  neural_rendering_resolution=IMG)
    return (JTCfg(sigma_separable=True, **common), TargetSamplerConfig(**common),
            JDCfg(image_size=IMG, bg_color=BG, raster_backend="pallas_diff"),
            DistillConfig(image_size=IMG, bg_color=BG))


def _draws(key):
    """The JAX step's draws, from its key splits (test_torch_train_step's)."""
    from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetDraws
    k_target, _ = jax.random.split(key)
    k_fov, k_cam, k_render, k_surf = jax.random.split(k_target, 4)
    kh, kv = jax.random.split(k_cam)
    k_strat, k_imp = jax.random.split(k_render)
    kf, kw, ks = jax.random.split(k_surf, 3)
    u = jax.random.uniform
    return TargetDraws(
        fov_u=_t(u(k_fov, ())), cam_h=_t(jax.random.normal(kh, (1, 1))),
        cam_v=_t(jax.random.normal(kv, (1, 1))),
        render=RenderDraws(_t(u(k_strat, (1, IMG * IMG, 4, 1))), _t(u(k_imp, (IMG * IMG, 4)))),
        face_u=_t(u(kf, (POINTS,))), weight_u=_t(u(kw, (POINTS, 3))),
        thickness_n=_t(jax.random.normal(ks, (POINTS,))))


@pytest.fixture(scope="module")
def step():
    """JAX's loss, metrics and gradients and the port's, for one EG3D step."""
    with jax.enable_x64(False):
        jg, gparams, frozen, _ = _generators(SMOKE_RK, dict(SMOKE_KW, without_sr=True), 2)
        jd, params, dec, _ = _decoders(jg, gparams, frozen, "exact", 1, pallas_heads_train=True)
        frozen.requires_grad_(False)
        vstate = vgg_state(1)
        vgg = VGG16LPIPS()
        load_vgg16_lpips_state(vgg, vstate)
        z = np.random.RandomState(0).randn(1, 32).astype(np.float32)
        # a random field has no meaningful iso-level (the CLI's 0.5 may cross
        # no cube): take a quantile of this latent's sigma grid, as
        # chip_smoke.py does
        with torch.no_grad():
            planes = frozen.synthesis_planes(frozen.mapping(torch.tensor(z), torch.zeros(1, 25)))
            sig = sigma_grid_separable(frozen, planes, shape_res=RES)
        jtcfg, tcfg, jdcfg, dcfg = _cfgs(float(torch.quantile(sig.flatten(), LEVEL_QUANTILE)))
        key = jax.random.PRNGKey(5)
        jfn = jmake_loss_fn(jd, gparams, JVGG(), JVGG().load_torch_state_dict(vstate), None,
                            None, jdcfg, jtcfg, JRCfg())
        (jloss, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
            params, key, jnp.asarray(z), 0)
        draws = _draws(key)
    vgg64 = copy.deepcopy(vgg).double()

    def lpips64(_, target, image, dtype=None):
        return lpips_loss(vgg64, target.double(), image.double()).float()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distill, "lpips_loss", lpips64)
        loss, metrics, aux = make_loss_fn(dec, frozen, vgg, dcfg, tcfg)(draws, torch.tensor(z), 0)
        loss.backward()
    grads = {name: (np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy())
             for name, p in dec.named_parameters()
             # G.decoder is not on the decode path: zero on both sides
             if not name.startswith("G.decoder.")}
    return (float(jloss), {k: float(v) for k, v in jmetrics.items()},
            decoder_state_dict(jd, jgrads), float(loss.detach()),
            {k: float(v) for k, v in metrics.items()}, grads)


@pytest.mark.parametrize("part", ["loss", "heads", "generator"])
def test_eg3d_train_step_matches_jax(step, part):
    jloss, jmetrics, ref, loss, metrics, grads = step
    if part == "loss":
        print(f"EG3D loss port {loss:.6f} JAX {jloss:.6f}")
        assert int(jmetrics["General/n_dropped"]) == 0
        assert abs(loss - jloss) <= 1e-4 * abs(jloss)
        for k, v in jmetrics.items():
            if k.startswith("Loss/"):
                assert abs(metrics[k] - v) <= 1e-4 * max(abs(v), 1e-3), k
        assert int(metrics["General/n_pairs"]) > 0
        return
    names = [n for n in grads if n.startswith(HEADS) == (part == "heads")]
    worst, n_checked = 0.0, 0
    for name in names:
        g, r = grads[name], ref[name]
        own = np.abs(r).max()
        err = np.abs(g - r).max() / max(own, 1e-12)
        if own > 0:
            n_checked += 1
            worst = max(worst, err)
        assert err <= 2e-3, (name, err, own)
    print(f"EG3D {part}: gradients of {n_checked} tensors, worst {worst:.3e} of their own max")
    assert n_checked >= (40 if part == "heads" else 50)


class _OSGDecoder(torch.nn.Module):
    """Pickles as EG3D's OSGDecoder: a plain (not persistent) torch module
    of the reference's training.triplane (eg3d/training/triplane.py:116)."""


_OSGDecoder.__module__, _OSGDecoder.__qualname__ = "training.triplane", "OSGDecoder"


@contextlib.contextmanager
def _training_triplane():
    pkg, mod = types.ModuleType("training"), types.ModuleType("training.triplane")
    mod.OSGDecoder = _OSGDecoder
    pkg.triplane = mod
    saved = {k: sys.modules.get(k) for k in ("training", "training.triplane")}
    sys.modules.update({"training": pkg, "training.triplane": mod})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_eg3d_weights_load_strictly(frame_models, sr_generators, tmp_path):
    """from_jax: the JAX EG3D decoder's export (heads + G, no t_mapping,
    background or torgb) loads strictly and bit for bit, and its
    generator's into a TriPlaneGenerator. Pickles: an EG3D G_ema with its
    OSGDecoder pickled as a plain torch module gives the JAX loader's state
    bit for bit and loads strictly into an 'eg3d' generator."""
    jd, params, td, sd = frame_models
    assert not any(k.startswith(("G.t_mapping.", "G.bcg_synthesis.", "G.torgb."))
                   for k in sd)
    dec = GaussianDecoder.from_config(td.config)
    load_decoder_state(dec, sd)
    assert all(np.array_equal(v.numpy(), sd[k]) for k, v in dec.state_dict().items())
    jg, gparams, _, _ = sr_generators
    gen = TriPlaneGenerator.from_config(sr_generators[2].config)
    gsd = generator_state_from_params(gparams)
    load_generator_state(gen, gsd)
    assert all(np.array_equal(v.numpy(), gsd[k]) for k, v in gen.state_dict().items())

    # a reference snapshot of an EG3D generator (with its SR stack):
    # persistent modules, and the OSG decoder a plain torch module holding
    # persistent FC layers
    flat = {k: v.clone() for k, v in gen.state_dict().items()}
    g = _modules({k: v for k, v in flat.items() if not k.startswith("decoder.")},
                 class_name="TriPlaneGenerator", init_args=(32, 25, 512, 128, 3),
                 init_kwargs={"rendering_kwargs": dict(gen.config.rendering_kwargs), "channel_base": 512,
                              "channel_max": 32, "num_fp16_res": 0, "sr_num_fp16_res": 0,
                              "mapping_kwargs": {}})
    net = torch.nn.Sequential()
    net._modules.update({"0": _modules({k[len("decoder.net.0."):]: v for k, v in flat.items()
                                        if k.startswith("decoder.net.0.")}),
                         "1": torch.nn.Softplus(),
                         "2": _modules({k[len("decoder.net.2."):]: v for k, v in flat.items()
                                        if k.startswith("decoder.net.2.")})})
    osg = _OSGDecoder()
    osg._modules["net"] = net
    g.modules["decoder"] = osg
    path = str(tmp_path / "eg3d.pkl")
    with _persistence_shim(), _training_triplane():
        blob = pickle.dumps({"G_ema": g})
    with open(path, "wb") as f:
        f.write(blob)
    pgen, state = torch_pickle.load_generator_pkl(path, device="cpu")
    jcfg, jparams = jpickle.load_generator_pkl(path)
    ref = generator_state_from_params(jparams)
    assert pgen.variant == jcfg.variant == "eg3d" and pgen.triplane_depth == 1
    assert set(state) == set(ref) and "decoder.net.0.weight" in state
    for k, v in ref.items():
        assert np.array_equal(state[k], v), k
    assert all(torch.equal(v, flat[k]) for k, v in pgen.state_dict().items())


def test_eg3d_trainer_snapshot_and_apps(tmp_path):
    """apps/train_decoder --generator_arch eg3d_ffhq --random_init --smoke
    on the CPU: 3 finite steps, a mid-run and a final snapshot; the final
    snapshot reloads as an EG3D decoder bit for bit, and the render (with
    its .ply) and eval apps run on it."""
    out = train_decoder.main(["--generator_arch", "eg3d_ffhq", "--random_init", "--smoke",
                              "--force_cpu", "--num_iter", "3", "--scalars_interval", "1",
                              "--save_model_interval", "2", "--eval_steps", "1",
                              "--outdir", str(tmp_path / "runs")])
    with open(os.path.join(out["outdir"], "stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert "final_eval" in rows.pop() and [r["step"] for r in rows] == [0, 1, 2]
    assert all(math.isfinite(r["Loss/total"]) and r["Loss/total"] > 0 for r in rows)
    assert os.path.exists(os.path.join(out["outdir"], "decoder_000002"))
    path = os.path.join(out["outdir"], "decoder_final")
    dec, configs = load_decoder(path, device="cpu")
    assert dec.config.generator.variant == "eg3d" and dec.G.triplane_depth == 1
    own = out["state"].decoder.state_dict()
    assert all(torch.equal(v, own[k]) for k, v in dec.state_dict().items())
    assert configs["frozen_G"].variant == "eg3d"
    r = render_decoder.main(["--checkpoint", path, "--image_size", "32", "--force_cpu",
                             "--out", str(tmp_path / "r.png"), "--ply", str(tmp_path / "r.ply")])
    assert os.path.getsize(r["image"]) > 0 and os.path.getsize(r["ply"]) > 0
    metrics = eval_decoder.main(["--checkpoint", path, "--eval_steps", "1", "--force_cpu"])
    assert metrics and all(math.isfinite(v) for v in metrics.values())
