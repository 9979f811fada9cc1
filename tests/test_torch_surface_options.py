"""The target pipeline's surface options against the JAX package's, on the
CPU:

- single-stage marching tetrahedra (marching_tetrahedra_faces(two_stage=
  False)) against JAX's _marching_tetrahedra_packed(two_stage=False) on a
  seeded 16^3 field: the same face count, the same faces in the same order
  with coordinates within 1e-6, no dropped cube; with every face, with the
  face_capacity clamp, and with no face (the capacity-fill row); and the
  same face count as the two-stage pack when no cube is dropped;
- the sigma > 10 voxel filter against JAX's (create_samples, then the
  first num_points voxels over 10 in index order, the rest voxel 0): the
  lattice and the points equal, with fewer and with more qualifying voxels
  than points;
- sample_target with the options on, with the same draws as JAX's (its
  key splits, as tests/test_torch_target.py feeds them), on the JAX CLI's
  --smoke generator with its density bias at 9.4 so that the JAX CLI's
  level and threshold 10 cross it: the int8 probe table with the gather
  sigma grid and single-stage marching tetrahedra; the bf16 probe table;
  the voxel filter on the gather grid of an f32 table (the port's built by
  K10's select form, JAX's by its XLA build: the same bytes). With an f32
  table the image within 1e-4 of its max, the sigma grid within 1e-5 of
  its max, the surface points within 1e-4. With an int8 or bf16 table the
  image and the sigma grid within 1e-3 of their max and the points within
  2e-3: the two sides' planes agree to f32 rounding, and a value that lies
  at a rounding boundary of the table's type takes the neighbouring code
  on the other side (an int8 step is 1/127 of its channel's absmax; a
  sigma that moves moves its surface crossing along the edge). Given the
  same planes the tables are equal bit for bit and sample within 1e-6
  (tests/test_torch_probe_tables.py).

The JAX side runs in float32 (x64 off)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder import surface as jsurface
from gaussian_gan_decoder_tpu.decoder.target_pipeline import (
    TargetSamplerConfig as JTargetCfg, sample_target as jsample_target)
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port.torch_export import generator_state_from_params
from gaussian_gan_decoder_tpu_torch.decoder import surface
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import (
    TargetDraws, TargetSamplerConfig, sample_target, voxel_filter)
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import RenderDraws
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_generator_state
from test_torch_decoder_train import _generator_params
from test_torch_train_step import GEN_KW, RK
from _torch_threads import torch_threads  # noqa: F401  (autouse)

R, POINTS, RES, LEVEL = 16, 1024, 32, 10.0
OPTIONS = {
    "int8-gather-single-stage": dict(int8_probe=True, sigma_separable=False,
                                     mt_two_stage=False),
    "bf16-probe": dict(bf16_probe=True),
    "voxel-filter": dict(use_marching_cubes=False, sigma_separable=False),
}


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


def test_single_stage_faces_match_jax():
    sig = (np.random.RandomState(5).randn(R, R, R) + 0.2).astype(np.float32)
    for case in ("all", "clamped", "empty"):
        level = 99.0 if case == "empty" else 0.5
        cap = 300 if case == "clamped" else 12 * (R - 1) ** 3
        jp, jn, jd = jsurface._marching_tetrahedra_packed(jnp.asarray(sig), level, cap,
                                                          two_stage=False)
        packed, n_faces, n_dropped = surface.marching_tetrahedra_faces(
            torch.tensor(sig), level, cap, two_stage=False)
        assert (n_faces, n_dropped) == (int(jn), int(jd)) and n_dropped == 0, case
        rows = max(1, min(n_faces, cap))
        assert packed.shape[0] == rows
        np.testing.assert_allclose(packed.numpy(), np.asarray(jp)[:rows, :9], atol=1e-6,
                                   err_msg=case)
        _, n_two, dropped_two = surface.marching_tetrahedra_faces(torch.tensor(sig), level, cap)
        assert dropped_two == 0 and n_two == n_faces
        assert (n_faces == 0) == (case == "empty") and (n_faces > cap) == (case == "clamped")


def test_voxel_filter_matches_jax():
    sig = (np.random.RandomState(6).randn(R, R, R) * 8.0).astype(np.float32)
    samples = jsurface.create_samples(R, 1.0)
    np.testing.assert_array_equal(surface.create_samples(R, 1.0).numpy(), np.asarray(samples))
    n_over = int((sig > 10.0).sum())
    assert 200 < n_over < 4000
    for n_points in (200, 4000):
        (idx,) = jnp.nonzero(jnp.asarray(sig).reshape(-1) > 10.0, size=n_points, fill_value=0)
        got = voxel_filter(torch.tensor(sig), 1.0, n_points)
        np.testing.assert_array_equal(got.numpy(), np.asarray(samples[0][idx]))


@pytest.fixture(scope="module")
def gens():
    """The --smoke generator on both sides, its density bias at 9.4."""
    with jax.enable_x64(False):
        jg = JGen(without_sr=True, rendering_kwargs=tuple(RK.items()), **GEN_KW)

        def init():
            gp = _generator_params(jg)
            gp["decoder"]["fc1"]["bias"] = gp["decoder"]["fc1"]["bias"].at[0].set(9.4)
            return gp

        params = jax.jit(init)()
    tg = TriPlaneGenerator(rendering_kwargs=RK, without_sr=True, **GEN_KW)
    load_generator_state(tg, generator_state_from_params(params))
    return jg, params, tg


def _draws(key):
    """sample_target's draws from its key (normal camera sampling)."""
    k_fov, k_cam, k_render, k_surf = jax.random.split(key, 4)
    kh, kv = jax.random.split(k_cam)
    k_strat, k_imp = jax.random.split(k_render)
    kf, kw, ks = jax.random.split(k_surf, 3)
    u = jax.random.uniform
    return TargetDraws(
        fov_u=_t(u(k_fov, ())), cam_h=_t(jax.random.normal(kh, (1, 1))),
        cam_v=_t(jax.random.normal(kv, (1, 1))),
        render=RenderDraws(_t(u(k_strat, (1, RES * RES, 4, 1))), _t(u(k_imp, (RES * RES, 4)))),
        face_u=_t(u(kf, (POINTS,))), weight_u=_t(u(kw, (POINTS, 3))),
        thickness_n=_t(jax.random.normal(ks, (POINTS,))))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_sample_target_options_match_jax(gens, option):
    jg, params, tg = gens
    common = dict(camera_sampling="normal", init_truncation=1.0, shape_res=R, num_points=POINTS,
                  mc_level=LEVEL, face_capacity=12 * (R - 1) ** 3, sigma_chunk=2 ** 10,
                  neural_rendering_resolution=RES)
    jcfg = JTargetCfg(**{"sigma_separable": True, **common, **OPTIONS[option]})
    extra = {"pallas_probe_build": "select"} if option == "voxel-filter" else {}
    cfg = TargetSamplerConfig(**common, **OPTIONS[option], **extra)
    z = np.random.RandomState(11).randn(1, 32).astype(np.float32)
    key = jax.random.PRNGKey(4)

    def jtarget(p, z):
        out = jsample_target(key, jg, p, z, iteration=0, cfg=jcfg)
        sig = jsurface.sigma_grid(jg, p, out.feature_planes, shape_res=R, chunk=2 ** 10,
                                  table=None if jcfg.sigma_separable else jg.build_sampling_table(
                                      out.feature_planes, brick_dtype=jnp.int8 if jcfg.int8_probe
                                      else None),
                                  separable=jcfg.sigma_separable)
        return out.img, out.vertices, sig

    img, verts, sig = jax.jit(jtarget)(params, jnp.asarray(z))
    out = sample_target(_draws(key), tg, torch.tensor(z), iteration=0, cfg=cfg)
    errs = _rel(out.img, img), _rel(out.sigmas, sig)
    over = int((out.sigmas > LEVEL).sum())
    dv = float(np.abs(out.vertices.numpy() - np.asarray(verts)).max())
    print(f"{option}: img {errs[0]:.3e}, sigma grid {errs[1]:.3e} of their max; "
          f"{over} of {R ** 3} voxels over {LEVEL}; points {dv:.3e}")
    quantised = cfg.probe_dtype is not None
    assert errs[0] <= (1e-3 if quantised else 1e-4) and errs[1] <= (1e-3 if quantised else 1e-5)
    assert 0 < over < R ** 3 // 2
    assert dv <= (2e-3 if quantised else 1e-4)
