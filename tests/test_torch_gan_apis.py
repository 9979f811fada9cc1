"""Port parity for the generator's GAN-side API (models/triplane.py,
models/stylegan2.py) against the JAX package, on small generators with the
2x super-resolution stack (z 32, w 512, 16^2 planes, 4 + 4 depth samples,
channel_base 512): the three repairs (the sigmoid PanoHead feature image,
the full rendering-kwarg presets, pose_from_hv's lookat), mapping with a
truncation cutoff, t_mapping / apply_delta_c under both
c_gen_conditioning_zero values, sample / sample_mixed, render_planes'
rk_overrides, apply and synthesis on PanoHead and EG3D (JAX's renderer
draws handed over as RenderDraws), and the t_mapping and bcg_synthesis
weights through from_jax and reference pickles, strictly and bit for bit.
The JAX side runs in float32 under jax.jit, x64 off. Tolerances: 1e-6 of
the largest reference value for the mapping and apply_delta_c, 1e-4 for
images (the render_planes tolerance of tests/test_torch_target.py)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder import camera_sampling as jcs
from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.models import triplane as jtriplane
from gaussian_gan_decoder_tpu.port import torch_pickle as jpickle
from gaussian_gan_decoder_tpu.port.torch_export import (
    decoder_state_dict, generator_state_from_params)
from gaussian_gan_decoder_tpu_torch.decoder import camera_sampling
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.models import triplane
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import RenderDraws
from gaussian_gan_decoder_tpu_torch.port import torch_pickle
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_decoder_state, load_generator_state
from test_torch_pickle import INIT_ARGS, INIT_KW, _dumps, _generator_flat, _modules
from _torch_threads import torch_threads  # noqa: F401  (autouse)

SR = "training.superresolution.SuperresolutionHybrid2X"
GEN_KW = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=128, channel_base=512,
              channel_max=32)
RK = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4,
      "superresolution_module": SR}
RES = 32          # neural rendering resolution: SR resizes its inputs to 64^2
IMAGES = ("image", "image_raw", "image_depth", "image_mask")


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _pair(variant="panohead", seed=0):
    """(JAX generator, its full params — TriPlaneGenerator.init, t_mapping and
    bcg_synthesis included — the port's generator with the same weights)."""
    jg = jtriplane.TriPlaneGenerator(variant=variant, rendering_kwargs=tuple(RK.items()),
                                     **GEN_KW)
    params = jax.jit(jg.init)(jax.random.PRNGKey(seed))
    # a non-zero density bias (a surface inside the box) and truncation target
    params["decoder"]["fc1"]["bias"] = params["decoder"]["fc1"]["bias"].at[0].set(0.3)
    rng = np.random.RandomState(seed)
    params["backbone"]["mapping"]["w_avg"] = jnp.asarray(rng.randn(512).astype(np.float32))
    tg = TriPlaneGenerator(variant=variant, rendering_kwargs=RK, **GEN_KW)
    load_generator_state(tg, generator_state_from_params(params))
    return jg, params, tg


@pytest.fixture(scope="module")
def pano():
    with jax.enable_x64(False):
        return _pair()


def _draws(key, n_rays, s, s_imp):
    """The renderer's draws from JAX's key, as its two passes split it."""
    k_strat, k_imp = jax.random.split(key)
    return RenderDraws(_t(jax.random.uniform(k_strat, (1, n_rays, s, 1), jnp.float32)),
                       _t(jax.random.uniform(k_imp, (n_rays, s_imp), jnp.float32)))


def _camera(yaw=0.3, pitch=-0.1, fov=18.0):
    pose = jcs._pose_from_hv(jnp.asarray([[math.pi / 2 + yaw]]),
                             jnp.asarray([[math.pi / 2 + pitch]]), 2.7)
    intr = jcs.FOV_to_intrinsics(jnp.asarray(fov))
    return np.asarray(jnp.concatenate([pose.reshape(1, 16), intr.reshape(1, 9)], axis=1),
                      np.float32)


def test_repairs_match_jax(pano):
    """(a) a PanoHead generator with a sigmoid decoder maps its feature image
    to (-1, 1) before the background blend (JAX triplane.py:355-357): every
    render_planes image within 1e-4; (b) default_rendering_kwargs equal JAX's
    presets key for key on both variants; (c) pose_from_hv takes JAX's
    lookat: within 1e-6."""
    for variant in ("panohead", "eg3d"):
        assert triplane.default_rendering_kwargs(variant) == \
            jtriplane.default_rendering_kwargs(variant), variant
    h, v = np.array([[1.2], [2.0]], np.float32), np.array([[1.4], [1.7]], np.float32)
    look = np.array([[0.0, 0.05, 0.2], [0.1, -0.1, 0.3]], np.float32)
    ref = jcs._pose_from_hv(jnp.asarray(h), jnp.asarray(v), 2.7, lookat=jnp.asarray(look))
    got = camera_sampling.pose_from_hv(_t(h), _t(v), 2.7, lookat=_t(look))
    assert _rel(got, ref) <= 1e-6
    assert _rel(camera_sampling.pose_from_hv(_t(h), _t(v), 2.7),
                jcs._pose_from_hv(jnp.asarray(h), jnp.asarray(v), 2.7)) <= 1e-6

    _, params, pg = pano
    rk = {**RK, "decoder_activation": "sigmoid"}
    jg = jtriplane.TriPlaneGenerator(rendering_kwargs=tuple(rk.items()), **GEN_KW)
    tg = TriPlaneGenerator(rendering_kwargs=rk, **GEN_KW)
    tg.load_state_dict(pg.state_dict(), strict=True)
    assert tg.decoder.activation == "sigmoid"
    z = np.random.RandomState(3).randn(1, 32).astype(np.float32)
    cp, key = _camera(), jax.random.PRNGKey(2)
    ref = jax.jit(lambda p, z, c: (lambda ws: jg.render_planes(
        p, jg.synthesis_planes(p, ws), ws, c, RES, key=key))(jg.mapping(p, z, c)))(
        params, jnp.asarray(z), jnp.asarray(cp))
    with torch.no_grad():
        ws = tg.mapping(_t(z), _t(cp))
        out = tg.render_planes(tg.synthesis_planes(ws), ws, _t(cp),
                               _draws(key, RES * RES, 4, 4), RES)
    for k in IMAGES:
        err = _rel(out[k], ref[k])
        print(f"sigmoid PanoHead render_planes {k}: {err:.3e}")
        assert err <= 1e-4, (k, err)


def test_gan_side_api_matches_jax(pano):
    """mapping with truncation_cutoff, t_mapping / apply_delta_c with both
    c_gen_conditioning_zero values (within 1e-6, on the generation apps'
    --smoke widths, w 32: at w 512 the mapping's f32 sums, taken in another
    order by XLA, read 1.4e-6), sample and sample_mixed (rgb and sigma
    within 1e-4), render_planes with rk_overrides (6 + 6 depth samples;
    images within 1e-4), and an error for random noise."""
    smoke = dict(GEN_KW, w_dim=32, img_resolution=32, without_sr=True)
    jsmoke = jtriplane.TriPlaneGenerator(rendering_kwargs=tuple(RK.items()), **smoke)
    km, kt = jax.random.split(jax.random.PRNGKey(8))
    sparams = {"backbone": {"mapping": jsmoke.backbone.mapping.init(km)},
               "t_mapping": jsmoke.t_mapping.init(kt)}
    rng = np.random.RandomState(4)
    sparams["backbone"]["mapping"]["w_avg"] = jnp.asarray(rng.randn(32).astype(np.float32))
    sparams["t_mapping"]["w_avg"] = jnp.asarray(rng.randn(3).astype(np.float32) * 0.1)
    flat = generator_state_from_params(sparams)
    z = rng.randn(2, 32).astype(np.float32)
    c = np.concatenate([_camera(), _camera(-0.5, 0.2)], axis=0)
    for zero in (False, True):
        jz = jtriplane.TriPlaneGenerator(
            rendering_kwargs=tuple({**RK, "c_gen_conditioning_zero": zero}.items()), **smoke)
        tz = TriPlaneGenerator(rendering_kwargs={**RK, "c_gen_conditioning_zero": zero},
                               **smoke)
        for name in ("backbone.mapping", "t_mapping"):
            tz.get_submodule(name).load_state_dict(
                {k[len(name) + 1:]: _t(v) for k, v in flat.items() if k.startswith(name + ".")},
                strict=True)
        jws, jc, jd = jax.jit(lambda p, z, c: (
            jz.mapping(p, z, c, truncation_psi=0.6, truncation_cutoff=3),
            *jz.apply_delta_c(p, z, c, truncation_psi=0.6, truncation_cutoff=3)))(
            sparams, jnp.asarray(z), jnp.asarray(c))
        with torch.no_grad():
            ws = tz.mapping(_t(z), _t(c), truncation_psi=0.6, truncation_cutoff=3)
            c_new, delta = tz.apply_delta_c(_t(z), _t(c), truncation_psi=0.6,
                                            truncation_cutoff=3)
        for name, got, ref in (("ws", ws, jws), ("c", c_new, jc), ("delta_c", delta, jd)):
            err = _rel(got, ref)
            print(f"c_gen_conditioning_zero={zero} {name}: {err:.3e}")
            assert err <= 1e-6, (zero, name, err)
        # the cutoff keeps the later ws untruncated
        assert not torch.allclose(ws[:, 2], ws[:, 3])
        assert bool((c_new[:, [0, 1, 2, 16]] == (0 if zero else _t(c)[:, [0, 1, 2, 16]])).all())

    jg, params, tg = pano
    coords = ((rng.rand(1, 300, 3) - 0.5) * 0.9).astype(np.float32)
    dirs = np.broadcast_to(np.float32([0, 0, -1]), (1, 300, 3))
    ref = jax.jit(lambda p, z, c: jg.sample(p, jnp.asarray(coords), jnp.asarray(dirs), z, c,
                                             truncation_psi=0.7))(
        params, jnp.asarray(z[:1]), jnp.asarray(c[:1]))
    with torch.no_grad():
        got = tg.sample(_t(coords), _t(dirs), _t(z[:1]), _t(c[:1]), truncation_psi=0.7)
        ws = tg.mapping(_t(z[:1]), _t(c[:1]), truncation_psi=0.7)
        mixed = tg.sample_mixed(_t(coords), _t(dirs), ws)
    for k in ("rgb", "sigma"):
        assert _rel(got[k], ref[k]) <= 1e-4, k
        assert torch.equal(mixed[k], got[k]), k

    key, over = jax.random.PRNGKey(6), {"depth_resolution": 6, "depth_resolution_importance": 6}
    ref = jax.jit(lambda p, z, c: (lambda ws: jg.render_planes(
        p, jg.synthesis_planes(p, ws), ws, c, RES, key=key, rk_overrides=over))(
        jg.mapping(p, z, c)))(params, jnp.asarray(z[:1]), jnp.asarray(c[:1]))
    with torch.no_grad():
        planes = tg.synthesis_planes(ws := tg.mapping(_t(z[:1]), _t(c[:1])))
        out = tg.render_planes(planes, ws, _t(c[:1]), _draws(key, RES * RES, 6, 6), RES,
                               rk_overrides=over)
        # a torch.Generator makes the draws at the overridden depths
        tg.render_planes(planes, ws, _t(c[:1]), torch.Generator().manual_seed(0), 8,
                         rk_overrides=over)
        with pytest.raises(ValueError, match="random"):
            tg.render_planes(planes, ws, _t(c[:1]), None, 8,
                             rk_overrides={"superresolution_noise_mode": "random"})
    for k in IMAGES:
        err = _rel(out[k], ref[k])
        print(f"render_planes rk_overrides {k}: {err:.3e}")
        assert err <= 1e-4, (k, err)


@pytest.mark.parametrize("variant", ["panohead", "eg3d"])
def test_apply_and_synthesis_match_jax(variant, pano):
    """apply (mapping, PanoHead's apply_delta_c, synthesis) and synthesis from
    fixed ws, with JAX's renderer draws: image, image_raw, image_depth (and
    PanoHead's image_mask) within 1e-4 of their largest value."""
    jg, params, tg = pano if variant == "panohead" else _pair(variant, seed=1)
    z = np.random.RandomState(5).randn(1, 32).astype(np.float32)
    cp, key = _camera(-0.4, 0.15), jax.random.PRNGKey(7)
    ws = np.asarray(jax.jit(lambda p, z, c: jg.mapping(p, z, c, truncation_psi=0.8))(
        params, jnp.asarray(z), jnp.asarray(cp)))
    ref, ref_s = jax.jit(lambda p, z, c, w: (
        jg.apply(p, z, c, truncation_psi=0.7, truncation_cutoff=4,
                 neural_rendering_resolution=RES, key=key),
        jg.synthesis(p, w, c, RES, key=key)))(
        params, jnp.asarray(z), jnp.asarray(cp), jnp.asarray(ws))
    draws = _draws(key, RES * RES, 4, 4)
    with torch.no_grad():
        out = tg.apply(_t(z), _t(cp), truncation_psi=0.7, truncation_cutoff=4,
                       neural_rendering_resolution=RES, draws=draws)
        out_s = tg.synthesis(_t(ws), _t(cp), draws, RES)
    keys = IMAGES if variant == "panohead" else IMAGES[:3]
    assert ("image_mask" in out) == (variant == "panohead")
    for name, got, want in (("apply", out, ref), ("synthesis", out_s, ref_s)):
        for k in keys:
            assert bool(torch.isfinite(got[k]).all()), (name, k)
            err = _rel(got[k], want[k])
            print(f"{variant} {name} {k}: {err:.3e}")
            assert err <= 1e-4, (variant, name, k, err)


def test_weights_load_strictly_bit_for_bit(pano, tmp_path):
    """t_mapping and bcg_synthesis cross from the JAX package (generator and
    decoder exports) and from a reference pickle, strictly and bit for bit;
    an export without t_mapping no longer loads."""
    jg, params, tg = pano
    sd = generator_state_from_params(params)
    own = tg.state_dict()
    for prefix in ("t_mapping.", "bcg_synthesis."):
        names = [k for k in sd if k.startswith(prefix)]
        assert names and set(names) == {k for k in own if k.startswith(prefix)}, prefix
    assert all(np.array_equal(own[k].numpy(), v) for k, v in sd.items())
    with pytest.raises(RuntimeError, match="Missing key"):
        load_generator_state(TriPlaneGenerator(rendering_kwargs=RK, **GEN_KW),
                             {k: v for k, v in sd.items() if not k.startswith("t_mapping.")})

    jd = JDec(generator=jg)
    dsd = decoder_state_dict(jd, jax.jit(lambda k: jd.init(k, generator_params=params))(
        jax.random.PRNGKey(3)))
    dec = GaussianDecoder(TriPlaneGenerator(rendering_kwargs=RK, **GEN_KW), gelu="exact")
    load_decoder_state(dec, dsd)
    got = dec.state_dict()
    assert any(k.startswith("G.bcg_synthesis.") for k in dsd)
    assert all(np.array_equal(got[k].numpy(), v) for k, v in dsd.items())

    gen, flat = _generator_flat()
    g = _modules(flat, class_name="TriPlaneGenerator", init_args=INIT_ARGS, init_kwargs=INIT_KW)
    path = str(tmp_path / "network.pkl")
    with open(path, "wb") as f:
        f.write(_dumps({"G_ema": g}))
    loaded, state = torch_pickle.load_generator_pkl(path, device="cpu")
    _, jparams = jpickle.load_generator_pkl(path)
    ref = generator_state_from_params(jparams)
    assert set(state) == set(ref) == set(loaded.state_dict())
    assert {"t_mapping.fc0.weight", "bcg_synthesis.b4.const"} <= set(state)
    for k, v in ref.items():
        assert np.array_equal(state[k], v), k
    assert all(torch.equal(v, torch.as_tensor(flat[k])) for k, v in loaded.state_dict().items())

