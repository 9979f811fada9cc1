"""Port parity for the training blend (K4 forward, K5 backward): the plain
PyTorch versions vs the JAX package's Pallas training blend in interpret
mode, on a few hundred Gaussians over a 64x64 image (16 tiles). The pairs
cover tiles past max_k, clamped alpha (opacity near 1) and pixels that
saturate below T = 1e-4. Tolerances: forward max|d| <= 1e-5; gradients
max|d| <= 1e-4 of each field's largest gradient (the cumulative products
are taken in another order: JAX doubles within 128-pair chunks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.splat.pallas_blend import _blend_train_fwd, pallas_blend_diff
from gaussian_gan_decoder_tpu_torch.splat.pallas_blend import (
    blend_tiles_diff, blend_train_bwd_plain, blend_train_plain)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

GRID, TS, MAX_K = 4, 16, 96
JAX_ROWS, CHUNK = 16, 128


def _pairs(seed=0):
    """Per-tile depth-ordered pairs -> (tile_starts (T+1,) int32, attrs
    (9, Ptot) f32). Tile 5 holds more than MAX_K pairs, tile 10 only
    near-opaque ones (its pixels saturate), every tile a few opacities
    whose peak alpha clamps at 0.99."""
    rng = np.random.RandomState(seed)
    T = GRID * GRID
    counts = rng.randint(5, 40, size=T)
    counts[5], counts[10], counts[3] = MAX_K + 40, 60, 0
    cols = []
    for t in range(T):
        n = counts[t]
        ox, oy = (t % GRID) * TS, (t // GRID) * TS
        px = ox + rng.uniform(-4, TS + 4, n)
        py = oy + rng.uniform(-4, TS + 4, n)
        sx, sy = rng.uniform(1.5, 7.0, n), rng.uniform(1.5, 7.0, n)
        rho = rng.uniform(-0.6, 0.6, n)
        det = (sx * sy) ** 2 * (1 - rho ** 2)
        ca, cb, cc = sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det
        op = rng.uniform(0.05, 0.95, n)
        op[rng.rand(n) < 0.15] = 0.999
        if t == 10:
            op[:] = rng.uniform(0.9, 0.999, n)
            sx[:] = 30.0
            ca, cb, cc = np.full(n, 1e-3), np.zeros(n), np.full(n, 1e-3)
        rgb = rng.uniform(0.0, 1.2, (3, n))
        cols.append(np.stack([px, py, ca, cb, cc, op, *rgb]))
    attrs = np.concatenate(cols, axis=1).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return starts, attrs


def _jax_attrs(attrs):
    """The JAX kernels' layout: 16 field rows, slack columns past the end."""
    a = np.zeros((JAX_ROWS, attrs.shape[1] + MAX_K + CHUNK), np.float32)
    a[:9, :attrs.shape[1]] = attrs
    return jnp.asarray(a)


def test_blend_train_forward_matches_jax():
    starts, attrs = _pairs()
    out, _ = _blend_train_fwd(jnp.asarray(starts), _jax_attrs(attrs), GRID, GRID, TS, MAX_K,
                              True)
    out = np.asarray(out)
    accum, trans = blend_train_plain(torch.tensor(starts), torch.tensor(attrs), GRID, GRID,
                                     TS, MAX_K)
    assert float(trans.min()) < 1e-4 < float(trans.max())     # saturated and open pixels
    np.testing.assert_allclose(accum.numpy(), out[..., :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(trans.numpy(), out[..., 3], rtol=0, atol=1e-5)


def test_blend_train_grads_match_jax():
    """Plain K5 vs jax.grad through pallas_blend_diff (interpret), and vs
    torch autograd of the plain forward, for a random linear loss on
    (accum, trans)."""
    starts, attrs = _pairs(1)
    rng = np.random.RandomState(2)
    T, P = GRID * GRID, TS * TS
    ra = rng.randn(T, P, 3).astype(np.float32)
    rt = rng.randn(T, P).astype(np.float32)

    def jloss(a):
        acc, tr = pallas_blend_diff(jnp.asarray(starts), a, GRID, GRID, TS, MAX_K, True)
        return jnp.sum(acc * ra) + jnp.sum(tr * rt)

    ref = np.asarray(jax.grad(jloss)(_jax_attrs(attrs)))[:9, :attrs.shape[1]]
    ts_, ta = torch.tensor(starts), torch.tensor(attrs)
    accum, trans = blend_train_plain(ts_, ta, GRID, GRID, TS, MAX_K)
    got = blend_train_bwd_plain(ts_, ta, accum, trans, torch.tensor(ra), torch.tensor(rt),
                                GRID, GRID, TS, MAX_K).numpy()
    scale = np.abs(ref).max(axis=1, keepdims=True)
    err = np.abs(got - ref) / scale
    print("per-field grad error / field max:", err.max(axis=1))
    assert (err <= 1e-4).all(), err.max(axis=1)
    # pairs past max_k and in the saturated tail get no gradient
    assert np.all(got[:, starts[5] + MAX_K:starts[6]] == 0)

    ta.requires_grad_(True)
    acc, tr = blend_tiles_diff(ts_, ta, GRID, GRID, TS, MAX_K)
    (torch.sum(acc * torch.tensor(ra)) + torch.sum(tr * torch.tensor(rt))).backward()
    np.testing.assert_allclose(ta.grad.numpy(), got, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [3, 4])
def test_blend_train_bwd_is_the_gradient_of_the_forward(seed):
    """The explicit backward equals torch autograd through the plain
    forward (cumprod and masks differentiated by torch), within 1e-4 of
    each field's largest gradient."""
    starts, attrs = _pairs(seed)
    rng = np.random.RandomState(seed)
    T, P = GRID * GRID, TS * TS
    ra = torch.tensor(rng.randn(T, P, 3).astype(np.float32))
    rt = torch.tensor(rng.randn(T, P).astype(np.float32))
    ts_ = torch.tensor(starts)
    ta = torch.tensor(attrs, requires_grad=True)
    accum, trans = blend_train_plain(ts_, ta, GRID, GRID, TS, MAX_K)
    (torch.sum(accum * ra) + torch.sum(trans * rt)).backward()
    with torch.no_grad():
        got = blend_train_bwd_plain(ts_, ta.detach(), accum.detach(), trans.detach(), ra, rt,
                                    GRID, GRID, TS, MAX_K)
    ref = ta.grad.numpy()
    err = np.abs(got.numpy() - ref) / np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-12)
    assert (err <= 1e-4).all(), err.max(axis=1)
