"""The frozen target's probe tables against the JAX package's, on the CPU, on
the JAX CLI's --smoke tri-grid generator (z/w 32, 16^2 planes of depth 3,
4 + 4 depth samples, no SR; the weights of tests/test_torch_train_step.py):

- generator.build_sampling_table at f32, bf16 and int8 (K10's plain
  version on the CPU) against JAX's XLA build: every row y0 <= H bit for
  bit (the port pads NY to K10's alignment, JAX's XLA build keeps H + 1),
  the int8 scales equal; the select form's table too;
- render_planes through an int8 and a bf16 probe table against JAX
  render_planes(plane_table=) with the same draws: each image within 1e-4
  of its max (the same table bits; the sums in another order);
- the gather sigma grid (sigma_grid(separable=False)) through an f32 and an
  int8 table against JAX's: within 1e-5 of its max; the f32 gather grid
  against the separable grid within 2e-5 (rtol and atol, the limit of JAX's
  tests/test_decoder.py::test_sigma_grid_separable_matches_gather), and a
  table handed to the separable grid refused.

The JAX side runs in float32 (x64 off); its tables are built eagerly, its
renders and grids under jax.jit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder import camera_sampling as jcs
from gaussian_gan_decoder_tpu.decoder.surface import sigma_grid as jsigma_grid
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port.torch_export import generator_state_from_params
from gaussian_gan_decoder_tpu_torch.decoder import surface
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import RenderDraws
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_generator_state
from test_torch_brick_table import _as_bits, _to_torch
from test_torch_decoder_train import _generator_params
from test_torch_train_step import GEN_KW, RK
from _torch_threads import torch_threads  # noqa: F401  (autouse)

RES, SHAPE_RES = 32, 16
DTYPES = {"int8": (jnp.int8, torch.int8), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (None, None)}


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
    """(JAX generator, its params, the port's generator, ws, planes)."""
    with jax.enable_x64(False):
        jg = JGen(without_sr=True, rendering_kwargs=tuple(RK.items()), **GEN_KW)
        params = jax.jit(lambda: _generator_params(jg))()
        z = np.random.RandomState(8).randn(1, 32).astype(np.float32)
        ws, planes = jax.jit(lambda p, z: (lambda ws: (ws, jg.synthesis_planes(
            p, ws, noise_mode="const")))(jg.mapping(p, z, jnp.zeros((1, 25)))))(params, z)
    tg = TriPlaneGenerator(rendering_kwargs=RK, without_sr=True, **GEN_KW)
    load_generator_state(tg, generator_state_from_params(params))
    return jg, params, tg, np.asarray(ws), np.asarray(planes)


def _tables(gens, name, pallas_build=False):
    jg, _, tg, _, planes = gens
    jdt, tdt = DTYPES[name]
    # eagerly: under jax.jit XLA may fold the scales' division by 127 into a
    # product, one rounding away from the eager (and the port's) quotient
    jt = jg.build_sampling_table(jnp.asarray(planes), brick_dtype=jdt)
    tt = tg.build_sampling_table(torch.tensor(planes), brick_dtype=tdt,
                                 pallas_build=pallas_build)
    return jt, tt


def test_sampling_table_matches_jax(gens):
    H, W = 16, 16
    for name, build in (("int8", False), ("bfloat16", False), ("float32", False),
                        ("int8", "select")):
        jt, tt = _tables(gens, name, build)
        assert len(tt) == len(jt) and tt[1] >= int(jt[1]) == H + 1
        got = tt[0].reshape(3, 4, tt[1], W + 1, -1)[:, :, :H + 1]
        ref = _to_torch(jt[0]).reshape(3, 4, int(jt[1]), W + 1, -1)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(_as_bits(got), _as_bits(ref), err_msg=f"{name} {build}")
        if name == "int8":
            np.testing.assert_array_equal(tt[2].numpy(), np.asarray(jt[2]))


@pytest.mark.parametrize("name", ["int8", "bfloat16"])
def test_render_planes_with_table_matches_jax(gens, name):
    jg, params, tg, ws, planes = gens
    jt, tt = _tables(gens, name)
    cp = np.asarray(jcs.sample_camera_params(jax.random.PRNGKey(1), jnp.float32(10.0))[0],
                    np.float32)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda p, pl, w, c, t: jg.render_planes(
        p, pl, w, c, neural_rendering_resolution=RES, key=key, plane_table=t))(
        params, planes, ws, cp, jt)
    k_strat, k_imp = jax.random.split(key)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    draws = RenderDraws(f32(jax.random.uniform(k_strat, (1, RES * RES, 4, 1))),
                        f32(jax.random.uniform(k_imp, (RES * RES, 4))))
    with torch.no_grad():
        out = tg.render_planes(f32(planes), f32(ws), f32(cp), draws,
                               neural_rendering_resolution=RES, plane_table=tt)
    for k in ("image_raw", "image_depth", "image_mask"):
        err = _rel(out[k], ref[k])
        print(f"render_planes {name} table {k}: {err:.3e}")
        assert err <= 1e-4, (k, err)


@pytest.mark.parametrize("name", ["float32", "int8"])
def test_gather_sigma_grid_matches_jax(gens, name):
    jg, params, tg, _, planes = gens
    jt, tt = _tables(gens, name)
    ref = jax.jit(lambda p, pl, t: jsigma_grid(jg, p, pl, shape_res=SHAPE_RES, chunk=2 ** 10,
                                               table=t))(params, planes, jt)
    with torch.no_grad():
        got = surface.sigma_grid(tg, torch.tensor(planes), shape_res=SHAPE_RES, chunk=2 ** 10,
                                 table=tt, separable=False)
        err = _rel(got, ref)
        print(f"gather sigma grid, {name} table: {err:.3e} of its max")
        assert err <= 1e-5
        if name == "float32":
            sep = surface.sigma_grid(tg, torch.tensor(planes), shape_res=SHAPE_RES)
            np.testing.assert_allclose(sep.numpy(), got.numpy(), rtol=2e-5, atol=2e-5)
            with pytest.raises(AssertionError, match="separable"):
                surface.sigma_grid(tg, torch.tensor(planes), shape_res=SHAPE_RES, table=tt)
