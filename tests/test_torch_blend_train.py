"""Port parity for the training blend (K4 forward, K5 backward): the plain
PyTorch versions vs the JAX package's Pallas training blend in interpret
mode, on a few hundred Gaussians over a 64x64 image (16 tiles). The pairs
cover tiles past max_k, clamped alpha (opacity near 1) and pixels that
saturate below T = 1e-4. Tolerances: forward max|d| <= 1e-5; gradients
max|d| <= 1e-4 of each field's largest gradient (the cumulative products
are taken in another order: JAX doubles within 128-pair chunks). The last
test models K4's chunked walk and scan in numpy float32 and holds it to
the JAX forward, the plain entries and a sequential fold, at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.splat.pallas_blend import _blend_train_fwd, pallas_blend_diff
from gaussian_gan_decoder_tpu_torch.splat.pallas_blend import (
    ENTRY_CHUNK, FAST_T, blend_tiles_diff, blend_train_bwd_plain, blend_train_entries_plain,
    blend_train_plain, entry_slots)
from _blend_train_cases import boundary_tiles
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


def _jax_attrs(attrs, max_k=MAX_K):
    """The JAX kernels' layout: 16 field rows, slack columns past the end."""
    a = np.zeros((JAX_ROWS, attrs.shape[1] + max_k + CHUNK), np.float32)
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


# -- K4's two passes (csrc/blend_train.cu), modelled in numpy float32 ------
ENTRY, STOP = ENTRY_CHUNK, np.float32(1e-4)
SCAN_K = 256   # 8 entry chunks, 2 of the JAX kernel's 128-pair chunks


def _scan_pairs(seed=7):
    """Tiles 0-4 the boundary cases of _blend_train_cases (a stop at the
    last pair of a chunk, at the first, T P_c inside the scan's margin, a
    product that underflows, a product and a fold on either side of 1e-4);
    tiles 5-15 wide, opaque Gaussians that stop pixels at scattered pairs,
    one tile past SCAN_K."""
    rng = np.random.RandomState(seed)
    origins = [((t % GRID) * TS, (t // GRID) * TS) for t in range(5)]
    cols = list(boundary_tiles(origins, rng).values())
    counts = rng.randint(20, 200, size=GRID * GRID - 5)
    counts[3] = SCAN_K + 30
    for t, n in enumerate(counts, start=5):
        ox, oy = (t % GRID) * TS, (t // GRID) * TS
        s = rng.uniform(3.0, 10.0, (2, n))
        rho = rng.uniform(-0.6, 0.6, n)
        det = (s[0] * s[1]) ** 2 * (1 - rho ** 2)
        cols.append(np.stack([ox + rng.uniform(-4, 20, n), oy + rng.uniform(-4, 20, n),
                              s[1] ** 2 / det, -rho * s[0] * s[1] / det, s[0] ** 2 / det,
                              rng.uniform(0.3, 0.99, n), *rng.uniform(0, 1.2, (3, n))]))
    attrs = np.concatenate(cols, axis=1).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum([c.shape[1] for c in cols])]).astype(np.int32)
    return starts, attrs


def _alpha(cols, t):
    """(P, n) alpha of a tile's pairs at its pixels, rounded op by op in the
    kernels' order (common.cuh::falloff_power, falloff_of)."""
    f = np.float32
    p = np.arange(TS * TS)
    dx = ((t % GRID) * TS + p % TS).astype(f)[:, None] - cols[0][None]
    dy = ((t // GRID) * TS + p // TS).astype(f)[:, None] - cols[1][None]
    quad = (cols[2][None] * dx) * dx + (cols[4][None] * dy) * dy
    power = f(-0.5) * quad - (cols[3][None] * dx) * dy
    with np.errstate(over="ignore"):
        alpha = np.minimum(f(0.99), cols[5][None] * np.exp(power))
    return np.where((power > 0) | (alpha < f(1) / f(255)), f(0), alpha)


def _fold(alpha, rgb, acc, T, open_):
    """The sequential walk with the stop, from (acc, T) at the pixels
    open_, in place -> the pair index (within alpha) each pixel stops at,
    -1 where none."""
    stop = np.full(T.shape, -1)
    for j in range(alpha.shape[1]):
        a = np.where(open_, alpha[:, j], np.float32(0))
        acc += (a * T)[:, None] * rgb[:, j][None]
        T[:] = np.where(open_, T * (np.float32(1) - a), T)
        hit = open_ & (T < STOP)
        stop[hit], open_ = j, open_ & ~hit
    return stop


def _two_pass_model(starts, attrs):
    """K4's arithmetic per tile -> out (T, P, 4), entries {(tile, chunk):
    (P, 4)}, stop pair per pixel (-1: none), and the (pixel, chunk) counts
    of the scan's paths. Pass 1: each chunk from T = 1 without the stop (a
    lane's k-th pixels left once all their products are below 1e-4,
    checked every 8 pairs); pass 2: the product where T P_c >= FAST_T,
    else the sequential replay."""
    f = np.float32
    out = np.zeros((GRID * GRID, TS * TS, 4), f)
    ent, stops = {}, np.full((GRID * GRID, TS * TS), -1)
    paths = dict(product=0, replay=0, margin=0, underflow=0)
    for t in range(GRID * GRID):
        n = min(starts[t + 1] - starts[t], SCAN_K)
        cols = attrs[:, starts[t]:starts[t] + n]
        alpha, rgb = _alpha(cols, t), cols[6:9]
        acc, T = np.zeros((TS * TS, 3), f), np.ones(TS * TS, f)
        for c in range(0, (n + ENTRY - 1) // ENTRY):
            j0, j1 = c * ENTRY, min(n, c * ENTRY + ENTRY)
            A, P = np.zeros((TS * TS, 3), f), np.ones(TS * TS, f)
            rows = np.ones(TS * TS, bool)   # a lane's k-th pixels: 32k to 32k + 31
            for g in range(j0, j1, 8):
                for j in range(g, min(j1, g + 8)):
                    a = np.where(rows, alpha[:, j], f(0))
                    A += (a * P)[:, None] * rgb[:, j][None]
                    P *= f(1) - a
                rows &= np.repeat((P >= STOP).reshape(8, 32).any(axis=1), 32)
            ent[t, c] = np.concatenate([acc, T[:, None]], axis=1)
            open_ = T >= STOP
            Tc = T * P
            take = open_ & (Tc >= FAST_T)
            acc[take] += T[take, None] * A[take]
            T = np.where(take, Tc, T)
            replay = open_ & ~take
            paths["product"] += int(take.sum())
            paths["replay"] += int(replay.sum())
            paths["margin"] += int((replay & (Tc >= STOP)).sum())
            paths["underflow"] += int((open_ & (P == 0)).sum())
            s = _fold(alpha[:, j0:j1], rgb[:, j0:j1], acc, T, replay)
            stops[t, s >= 0] = j0 + s[s >= 0]
        out[t, :, :3], out[t, :, 3] = acc, T
    return out, ent, stops, paths


def test_blend_train_two_pass_model():
    """K4's two passes, modelled in numpy float32, against the JAX training
    blend (interpret mode: its output, and its entries T at every 128-pair
    chunk) and the plain version's entries (accum rgb and T at every
    32-pair chunk), within 1e-5 (the products are taken in another order);
    the model's mask decisions are those of a sequential fold from each
    entry (K5's replay): it stops a pixel at the same pair, and never
    inside a chunk whose product it took."""
    starts, attrs = _scan_pairs()
    out, ent, stops, paths = _two_pass_model(starts, attrs)
    print("scan paths (pixel, chunk):", paths)
    # the boundary cases happen: stops at the last and the first pair of a
    # chunk, T P_c inside the margin, a product that underflowed, and one
    # that only the margin keeps from stopping no pixel (tile 4)
    assert stops[0].min() == ENTRY - 1 and stops[1].min() == 4 * ENTRY
    assert paths["margin"] >= 2 * TS * TS and paths["underflow"] > 0
    assert (stops[4] == 2 * ENTRY - 1).all()
    assert 0.2 < float((out[..., 3] < 1e-4).mean()) < 0.95

    j_out, j_ent = _blend_train_fwd(jnp.asarray(starts), _jax_attrs(attrs, SCAN_K), GRID, GRID,
                                    TS, SCAN_K, True)
    np.testing.assert_allclose(out, np.asarray(j_out), rtol=0, atol=1e-5)
    # the JAX kernel's entry ci is T before the tile's pair ci 128 - offset
    # (its chunks are 128-aligned in the whole pair array): the model's T
    # there, folded from the model's entry before it
    j_ent = np.asarray(j_ent)
    for t in range(GRID * GRID):
        n = min(starts[t + 1] - starts[t], SCAN_K)
        offset = starts[t] % CHUNK
        for ci in range(1, (offset + n + CHUNK - 1) // CHUNK):
            j = ci * CHUNK - offset
            c = j // ENTRY
            cols = attrs[:, starts[t] + c * ENTRY:starts[t] + j]
            e = ent[t, c]
            T = e[:, 3].copy()
            _fold(_alpha(cols, t), cols[6:9], e[:, :3].copy(), T, T >= STOP)
            np.testing.assert_allclose(T, j_ent[t, ci], rtol=0, atol=1e-5)

    ent_p = blend_train_entries_plain(torch.tensor(starts), torch.tensor(attrs), GRID, GRID, TS,
                                      SCAN_K).numpy()
    tile, local, slot = (x.numpy() for x in entry_slots(torch.tensor(starts), SCAN_K))
    assert len(tile) == len(ent)
    for t, c, b in zip(tile, local, slot):
        np.testing.assert_allclose(ent[t, c], ent_p[b], rtol=0, atol=1e-5)

    # K5 folds every chunk from its entry: the stop it finds is the model's
    for (t, c), e in ent.items():
        n = min(starts[t + 1] - starts[t], SCAN_K)
        j0, j1 = c * ENTRY, min(n, c * ENTRY + ENTRY)
        cols = attrs[:, starts[t] + j0:starts[t] + j1]
        open_ = e[:, 3] >= STOP
        s = _fold(_alpha(cols, t), cols[6:9], e[:, :3].copy(), e[:, 3].copy(), open_.copy())
        in_chunk = (stops[t] >= j0) & (stops[t] < j1)
        np.testing.assert_array_equal(np.where(s >= 0, j0 + s, -1)[open_],
                                      np.where(in_chunk, stops[t], -1)[open_])
