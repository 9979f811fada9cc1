"""Port parity for the distillation target pipeline vs the JAX package, on
the JAX CLI's --smoke generator shape (z 32, 16^2 tri-grid of depth 3, 4 + 4
depth samples, channel_base 512; w 512, which the SR stack needs) with the
SuperresolutionHybrid2X
stack (input 64^2, output 128^2) in f32: camera sampling, render_planes
(coarse + importance passes with the JAX draws injected, the resize path
and the raw-image alias path), the separable sigma grid, the
marching-tetrahedra faces and samples, and sample_target end to end. The
draws are JAX's, rebuilt from its key splits and handed to the port. The
JAX side runs in float32, with x64 off as the JAX CLI runs (the repository's
conftest turns x64 on for the JAX package's own float64 golden tests, and
under it the JAX renderer and samplers promote to float64). Tolerances are
stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder import camera_sampling as jcs
from gaussian_gan_decoder_tpu.decoder import surface as jsurface
from gaussian_gan_decoder_tpu.decoder.target_pipeline import (
    TargetSamplerConfig as JTargetCfg, sample_target as jsample_target)
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.ops import resize_bilinear as jresize
from gaussian_gan_decoder_tpu.port.torch_export import generator_state_from_params
from gaussian_gan_decoder_tpu_torch.decoder import camera_sampling, surface
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import (
    TargetDraws, TargetSamplerConfig, sample_target)
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import RenderDraws
from gaussian_gan_decoder_tpu_torch.ops import resize_bilinear
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_generator_state
from _gan_parts import with_gan_parts
from _torch_threads import torch_threads  # noqa: F401  (autouse)

SR = "training.superresolution.SuperresolutionHybrid2X"
RK = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4,
      "c_gen_conditioning_zero": True, "superresolution_module": SR}
GEN_KW = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=128, channel_base=512,
              channel_max=32)
SHAPE_RES, POINTS, LEVEL = 16, 1024, 0.5
DEF = jnp.float32   # jax.random's default float type with x64 off


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


@pytest.fixture(scope="module")
def gens():
    jg = JGen(rendering_kwargs=tuple(RK.items()), **GEN_KW)

    def init():
        ks = jax.random.split(jax.random.PRNGKey(0), 4)
        p = {"backbone": jg.backbone.init(ks[0]), "decoder": jg.decoder.init(ks[1]),
             "superresolution": jg.superresolution.init(ks[2]), "torgb": jg.torgb.init(ks[3])}
        # non-zero density bias: a surface at LEVEL inside the sampling cube
        p["decoder"]["fc1"]["bias"] = p["decoder"]["fc1"]["bias"].at[0].set(0.3)
        return with_gan_parts(jg, p)

    params = jax.jit(init)()
    tg = TriPlaneGenerator(rendering_kwargs=RK, **GEN_KW)
    load_generator_state(tg, generator_state_from_params(params))
    return jg, params, tg


def _camera(key, dtype):
    """JAX's camera draws of sample_target (normal sampling)."""
    k_fov, k_cam, _, _ = jax.random.split(key, 4)
    kh, kv = jax.random.split(k_cam)
    return (jax.random.uniform(k_fov, (), dtype), jax.random.normal(kh, (1, 1), dtype),
            jax.random.normal(kv, (1, 1), dtype))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_camera_sampling_matches_jax():
    """camera_params and cam2world within 1e-6."""
    fov_u, h, v = _camera(jax.random.PRNGKey(3), DEF)
    fov = fov_u * 12.0 + 5.0
    cp, pose, jh, jv = jcs.sample_camera_params(jax.random.split(jax.random.PRNGKey(3), 4)[1],
                                                fov, "normal", 1.0, 0.3, 2.7)
    tcp, tpose, th, tv = camera_sampling.sample_camera_params(_t(h), _t(v), _t(fov), "normal",
                                                              1.0, 0.3, 2.7)
    np.testing.assert_allclose(tcp.numpy(), np.asarray(cp), atol=1e-6)
    np.testing.assert_allclose(tpose.numpy(), np.asarray(pose), atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)


@pytest.mark.parametrize("antialias", [False, True])
def test_resize_matches_jax(antialias):
    x = np.random.RandomState(0).randn(2, 3, 24, 40).astype(np.float32)
    for oh, ow in ((48, 64), (16, 10)):
        ref = jresize(jnp.asarray(x), oh, ow, antialias=antialias)
        assert _rel(resize_bilinear(torch.tensor(x), oh, ow, antialias=antialias), ref) <= 1e-6


@pytest.mark.parametrize("res", [32, 64], ids=["resize", "raw-alias"])
def test_render_planes_matches_jax(gens, res):
    """Volume render (coarse + importance with JAX's draws) + raw ToRGB + SR
    from the same planes: every image within 1e-4 of its max. At res 32 the
    SR resizes its inputs to 64^2; at 64 block0 adds its ToRGB skip into
    image_raw (the reference's in-place alias)."""
    jg, params, tg = gens
    rng = np.random.RandomState(res)
    z = rng.randn(1, 32).astype(np.float32)
    cp = np.asarray(jcs.sample_camera_params(jax.random.PRNGKey(1), jnp.float32(10.0))[0],
                    np.float32)
    ws = jg.mapping(params, jnp.asarray(z), jnp.zeros((1, 25), jnp.float32))
    planes = jg.synthesis_planes(params, ws, noise_mode="const")
    key = jax.random.PRNGKey(2)
    ref = jg.render_planes(params, planes, ws, jnp.asarray(cp), neural_rendering_resolution=res,
                           key=key)
    k_strat, k_imp = jax.random.split(key)
    draws = RenderDraws(_t(jax.random.uniform(k_strat, (1, res * res, 4, 1), DEF)),
                        _t(jax.random.uniform(k_imp, (res * res, 4), DEF)))
    with torch.no_grad():
        out = tg.render_planes(_t(planes), _t(ws), _t(cp), draws,
                               neural_rendering_resolution=res)
    for k in ("image_raw", "image_depth", "image_mask", "image"):
        err = _rel(out[k], ref[k])
        print(f"render_planes[{res}] {k}: {err:.3e}")
        assert err <= 1e-4, (k, err)


@pytest.fixture(scope="module")
def planes(gens):
    jg, params, _ = gens
    z = np.random.RandomState(7).randn(1, 32).astype(np.float32)
    ws = jg.mapping(params, jnp.asarray(z), jnp.zeros((1, 25), jnp.float32))
    return np.asarray(jg.synthesis_planes(params, ws, noise_mode="const"))


def test_sigma_grid_matches_jax(gens, planes):
    """Separable sigma grid (16^3): within 1e-5 of its max."""
    jg, params, tg = gens
    ref = jsurface.sigma_grid_separable(jg, params, jnp.asarray(planes), shape_res=SHAPE_RES)
    with torch.no_grad():
        got = surface.sigma_grid_separable(tg, _t(planes), shape_res=SHAPE_RES, chunk=1000)
    assert _rel(got, ref) <= 1e-5


def test_marching_tetrahedra_matches_jax():
    """Faces of the two-stage compaction in the JAX order, and surface
    samples with JAX's draws injected: within 1e-5."""
    rng = np.random.RandomState(5)
    sig = (rng.randn(SHAPE_RES, SHAPE_RES, SHAPE_RES) + 0.2).astype(np.float32)
    cap = 12 * (SHAPE_RES - 1) ** 3
    jp, jn, jd = jsurface._marching_tetrahedra_packed(jnp.asarray(sig), LEVEL, cap,
                                                      two_stage=True)
    packed, n_faces, n_dropped = surface.marching_tetrahedra_faces(torch.tensor(sig), LEVEL, cap)
    assert (n_faces, n_dropped) == (int(jn), int(jd)) and n_faces > 100
    np.testing.assert_allclose(packed.numpy(), np.asarray(jp)[:n_faces, :9], atol=1e-5)
    key = jax.random.PRNGKey(9)
    ref = jsurface.marching_tetrahedra_sample(key, jnp.asarray(sig), LEVEL, POINTS, 0.1, cap,
                                              two_stage=True)
    kf, kw, ks = jax.random.split(key, 3)
    got = surface.marching_tetrahedra_sample(
        torch.tensor(sig), _t(jax.random.uniform(kf, (POINTS,), DEF)),
        _t(jax.random.uniform(kw, (POINTS, 3), jnp.float32)),
        _t(jax.random.normal(ks, (POINTS,), jnp.float32)), LEVEL, 0.1, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_sample_target_matches_jax(gens):
    """sample_target end to end with the same draws: camera params within
    1e-6, the target image within 1e-4 of its max, the surface points within
    1e-4."""
    jg, params, tg = gens
    jcfg = JTargetCfg(camera_sampling="normal", init_truncation=1.0, shape_res=SHAPE_RES,
                      num_points=POINTS, mc_level=LEVEL, sigma_separable=True,
                      face_capacity=12 * (SHAPE_RES - 1) ** 3, neural_rendering_resolution=32)
    cfg = TargetSamplerConfig(camera_sampling="normal", init_truncation=1.0,
                              shape_res=SHAPE_RES, num_points=POINTS, mc_level=LEVEL,
                              face_capacity=12 * (SHAPE_RES - 1) ** 3,
                              neural_rendering_resolution=32)
    z = np.random.RandomState(11).randn(1, 32).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jsample_target(key, jg, params, jnp.asarray(z), iteration=0, cfg=jcfg)
    fov_u, h, v = _camera(key, DEF)
    _, _, k_render, k_surf = jax.random.split(key, 4)
    k_strat, k_imp = jax.random.split(k_render)
    kf, kw, ks = jax.random.split(k_surf, 3)
    draws = TargetDraws(
        fov_u=_t(fov_u), cam_h=_t(h), cam_v=_t(v),
        render=RenderDraws(_t(jax.random.uniform(k_strat, (1, 32 * 32, 4, 1), DEF)),
                           _t(jax.random.uniform(k_imp, (32 * 32, 4), DEF))),
        face_u=_t(jax.random.uniform(kf, (POINTS,), DEF)),
        weight_u=_t(jax.random.uniform(kw, (POINTS, 3), DEF)),
        thickness_n=_t(jax.random.normal(ks, (POINTS,), DEF)))
    out = sample_target(draws, tg, torch.tensor(z), iteration=0, cfg=cfg)
    assert _rel(out.gan_camera_params, ref.gan_camera_params) <= 1e-6
    err = _rel(out.img, ref.img)
    print(f"sample_target img: {err:.3e}")
    assert err <= 1e-4
    assert tuple(out.vertices.shape) == (POINTS, 3)
    np.testing.assert_allclose(out.vertices.numpy(), np.asarray(ref.vertices), atol=1e-4)
