"""Port parity of the brick-table route's sampling: the brick-table build
(kernel K10's plain version, neuralfield/pallas_expand.py) against the JAX
package's Pallas build_brick_table (interpret mode) and its XLA 8-slice
concat, and the plane table (int8 with absmax scales, bf16, f32) + table
sample against the JAX build_plane_table / sample_from_planes, on seeded
(3, 32, 3, 16, 16) volumes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.neuralfield.pallas_expand import build_brick_table as jbuild
from gaussian_gan_decoder_tpu.neuralfield.renderer import _trilinear_table as jtable
from gaussian_gan_decoder_tpu.neuralfield.renderer import build_plane_table as jplane_table
from gaussian_gan_decoder_tpu.neuralfield.renderer import generate_planes
from gaussian_gan_decoder_tpu.neuralfield.renderer import sample_from_planes as jsample
from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
    build_plane_table, sample_from_planes)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

B, C, D, H, W = 3, 32, 3, 16, 16


def _volume(dtype: str, seed: int):
    feats = np.random.RandomState(seed).randn(B, C, D, H, W).astype(np.float32)
    if dtype == "int8":
        return np.clip(np.round(feats * 30), -127, 127).astype(np.int8)
    return feats


def _to_torch(a):
    """numpy (or JAX) array -> torch tensor of the same dtype, bf16 included."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _as_bits(t: torch.Tensor) -> np.ndarray:
    """Bit patterns for an exact comparison of any dtype."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_brick_table_matches_jax(dtype):
    """The plain K10 against the JAX Pallas build and the XLA concat: the
    same NY, every row y0 <= H bit-exact, the rows y0 > H zero."""
    fj = jnp.asarray(_volume(dtype, 7)).astype(dtype)
    ft = _to_torch(fj)
    before = pallas_expand.brick_table.launches
    e, NY = pallas_expand.build_brick_table(ft)
    assert pallas_expand.brick_table.launches == before
    je, jNY = jbuild(fj, interpret=True)
    assert NY == jNY and e.dtype == ft.dtype and tuple(e.shape) == tuple(je.shape)
    got = e.reshape(B, D + 1, NY, W + 1, 8 * C)
    ref = _to_torch(je).reshape(B, D + 1, NY, W + 1, 8 * C)
    np.testing.assert_array_equal(_as_bits(got[:, :, :H + 1]), _as_bits(ref[:, :, :H + 1]))
    assert not got[:, :, H + 1:].any()
    xla, xNY = jtable(fj, pallas_build=False)
    assert xNY == H + 1
    np.testing.assert_array_equal(
        _as_bits(got[:, :, :H + 1].reshape(xla.shape)), _as_bits(_to_torch(xla)))


def test_int8_table_sample_matches_jax():
    """int8 plane table (absmax scales per plane and channel) and the table
    sample at points spread past the box: scales bit-exact, the table's
    indexable rows bit-exact, features within 1e-6 of their max."""
    rng = np.random.RandomState(3)
    planes = rng.randn(1, 3, C * D, H, W).astype(np.float32)
    coords = ((rng.rand(1, 400, 3) - 0.5) * 1.3).astype(np.float32)
    je, jNY, jscales = jplane_table(jnp.asarray(planes), D, brick_dtype=jnp.int8,
                                    pallas_build=True)
    e, NY, scales = build_plane_table(torch.tensor(planes), D, brick_dtype=torch.int8)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    assert NY == jNY and e.dtype == torch.int8
    rows = e.reshape(3, D + 1, NY, W + 1, 8 * C)[:, :, :H + 1]
    jrows = np.asarray(je).reshape(3, D + 1, NY, W + 1, 8 * C)[:, :, :H + 1]
    np.testing.assert_array_equal(rows.numpy(), jrows)
    axes = generate_planes("panohead")
    ref = np.asarray(jsample(axes, jnp.asarray(planes), jnp.asarray(coords), box_warp=1.0,
                             triplane_depth=D, brick_dtype=jnp.int8))
    got = sample_from_planes(axes, torch.tensor(planes), torch.tensor(coords), 1.0, D,
                             table=(e, NY, scales))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    print(f"int8 table sample vs JAX: {err:.3e} of max")
    assert err <= 1e-6


def test_float_table_sample_matches_jax():
    """Float plane tables (bf16, and f32: the planes' own dtype) and the
    table sample at points spread past the box: the table's indexable rows
    bit-exact, features (corners in the table's dtype times f32 weights, as
    JAX promotes them) within 1e-6 of their max. One test for both dtypes
    keeps this file at 5 tests, which xdist's loadfile hands out after the
    long JAX-side tests/test_points_sharding.py."""
    rng = np.random.RandomState(4)
    planes = rng.randn(1, 3, C * D, H, W).astype(np.float32)
    coords = ((rng.rand(1, 400, 3) - 0.5) * 1.3).astype(np.float32)
    axes = generate_planes("panohead")
    for dtype in ("bfloat16", "float32"):
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        je, jNY = jplane_table(jnp.asarray(planes), D, brick_dtype=jdt, pallas_build=True)
        e, NY = build_plane_table(torch.tensor(planes), D, brick_dtype=tdt)
        assert NY == jNY and e.dtype == tdt
        rows = e.reshape(3, D + 1, NY, W + 1, 8 * C)[:, :, :H + 1]
        jrows = _to_torch(je).reshape(3, D + 1, NY, W + 1, 8 * C)[:, :, :H + 1]
        np.testing.assert_array_equal(_as_bits(rows), _as_bits(jrows))
        ref = np.asarray(jsample(axes, jnp.asarray(planes), jnp.asarray(coords), box_warp=1.0,
                                 triplane_depth=D, brick_dtype=jdt))
        got = sample_from_planes(axes, torch.tensor(planes), torch.tensor(coords), 1.0, D,
                                 table=(e, NY))
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        print(f"{dtype} table sample vs JAX: {err:.3e} of max")
        assert err <= 1e-6, dtype
