"""Per-tile front-to-back alpha blending — port of splat/pallas_blend.py:
the frame blend (K3) in its four payload formats, and the training blend
(K4 / K5) below.

Kernel K3, csrc/blend.cu::blend_kernel<format, mxu_power>, replaces the TPU
kernel splat/pallas_blend.py::pallas_blend (`_blend_kernel`, every
payload_format and mxu_power). What bounds it on the H100: the issue rate
of the CUDA cores. T keeps decaying past the stop, so no pixel stops early:
each blended pair is evaluated at every pixel of its tile within the pair's
reach, each evaluation a chain of ~28 f32 operations and an exp (the
falloff is rounded op by op, without FMAs); the pair stream of a tile is
read once. Its design: one block of 128 threads per 16x16 tile, each warp 4
of the tile's rows, each thread two pixels of one column, so a pair read
from shared memory and the falloff's dx terms serve two pixels and two
independent transmittance chains overlap their latencies; the tile's
depth-sorted pair words are staged by cp.async, double-buffered in chunks
of 64, and the thread that staged a pair unpacks it once into 12 floats
(three 16-byte shared loads a pair for every reader); a warp skips a pair
whose reach (the ellipse beyond which its alpha is below 1/255, with
margins for rounding, from the unpacked conic and opacity) misses its rows
of the tile, as its alpha would be 0 at each pixel there. The blend is the
sequential form of the TPU kernel's in-chunk cumprod.

Semantics (kernel and blend_tiles_plain): pixel coords are the integers
tx + p % ts, ty + p // ts (no +0.5), tile-local (no tile origin) in the
packed formats, whose pair coordinates are tile-local; pairs [start,
start + min(end-start, max_k)); power = -0.5 (ca dx^2 + cc dy^2) - cb dx
dy, dx = pixel x - pair x, or with mxu_power (packed formats only) the
quadratic polynomial of the pixel's coordinates, ((((c0 + c1 x) + c2 y) +
c3 x^2) + c4 x y) + c5 y^2 with the JAX kernel's coefficients (c0 = -0.5
(ca gx gx + cc gy gy) - cb gx gy, c1 = ca gx + cb gy, c2 = cc gy + cb gx,
c3 = -0.5 ca, c4 = -cb, c5 = -0.5 cc), every product and sum rounded on
its own in that order; alpha = min(0.99, op exp(power)), zeroed where
power > 0 or alpha < 1/255; the weight is alpha * T only while T >= 1e-4,
and T keeps decaying past that stop. The mxu_power form skips no pair:
its polynomial rounds differently from the direct form, so the reach test
does not bound it.

Payload rows (field-major f32-bitcast words, (PAYLOAD_ROWS[format], P);
splat/fast_raster.py packs them): f32 px, py, ca, cb, cc, op, r, g, b;
bf16_colors px, py, ca, cb, cc, r|g, b|op (bf16 pairs, high half first);
packed_v2 pxl|pyl (int16, 1/32 px), ca|cb (f16 of conic * 4096), cc, r|g,
b|op; packed_v3 pxl|pyl, ca|cb, cc|op (f16 * 4096), rgb (10 bits each,
1/256). Unpacking is the JAX kernel's: an f16 pattern with exponent e
becomes the f32 of exponent e + 100 (the 4096 folded in), 0 where e = 0.
"""
from __future__ import annotations

import torch

from .. import kernel_lib

ROWS = 9
# payload format -> its words a pair, and the kernel's format id
PAYLOAD_ROWS = {"f32": 9, "bf16_colors": 7, "packed_v2": 5, "packed_v3": 4}
PAYLOAD_IDS = {"f32": 0, "bf16_colors": 1, "packed_v2": 2, "packed_v3": 3}
PACKED = ("packed_v2", "packed_v3")
F16_REBIAS = 12              # log2 of the conic pre-scale (fast_raster.CONIC_SCALE)
PLAIN_TILES_PER_CHUNK = 64   # tiles per step of the plain version
ENTRY_CHUNK = 32             # pairs of a training chunk: K4's entries, K5's unit of work
# K4's scan takes a chunk's product of (1 - alpha) where the T before the
# chunk times it is at least FAST_T, 1e-4 with a margin of 1e-4 relative
# (csrc/blend_train.cu kFastT, the same f32 value), and replays the chunk's
# pairs elsewhere
FAST_T = (torch.tensor(1e-4) * (1.0 + torch.tensor(1e-4))).item()


def blend_form(payload_format: str = "f32", mxu_power: bool = False) -> str:
    """The name of K3's form (its launch counter is `launches_<form>`,
    `launches` for f32): the format, '_mxu' appended with mxu_power.
    Raises for a combination the JAX kernel refuses."""
    if payload_format not in PAYLOAD_ROWS:
        raise ValueError(f"payload_format {payload_format!r}: one of {sorted(PAYLOAD_ROWS)}")
    if mxu_power and payload_format not in PACKED:
        raise ValueError("mxu_power needs a packed payload format (tile-local coordinates), "
                         f"not {payload_format!r}")
    return payload_format + ("_mxu" if mxu_power else "")


def _launch_attr(form: str) -> str:
    return "launches" if form == "f32" else f"launches_{form}"


def f16_unpack(u: torch.Tensor, rebias: int = F16_REBIAS) -> torch.Tensor:
    """IEEE-half patterns (low 16 bits of int32) -> f32 with the exponent
    re-biased by -rebias powers of two, subnormals to 0: JAX _f16_unpack."""
    e = (u >> 10) & 0x1F
    b = ((u & 0x8000) << 16) | ((e + (127 - 15 - rebias)) << 23) | ((u & 0x3FF) << 13)
    return torch.where(e == 0, torch.zeros((), dtype=torch.float32), b.view(torch.float32))


def unpack_payload(a: torch.Tensor, payload_format: str):
    """Payload words (n, ...) -> the 9 f32 fields (px, py, ca, cb, cc, op,
    r, g, b), each shaped like a[0]: the JAX kernel's unpacking."""
    if payload_format == "f32":
        return tuple(a[i] for i in range(9))
    w = a.contiguous().view(torch.int32)
    hi = lambda v: (v & -65536).view(torch.float32)   # noqa: E731
    lo = lambda v: (v << 16).view(torch.float32)      # noqa: E731
    if payload_format == "bf16_colors":
        return (a[0], a[1], a[2], a[3], a[4], lo(w[6]), hi(w[5]), lo(w[5]), hi(w[6]))
    gx = (w[0] >> 16).float() * (1.0 / 32.0)
    gy = ((w[0] << 16) >> 16).float() * (1.0 / 32.0)
    ca, cb = f16_unpack((w[1] >> 16) & 0xFFFF), f16_unpack(w[1] & 0xFFFF)
    if payload_format == "packed_v2":
        return (gx, gy, ca, cb, a[2], lo(w[4]), hi(w[3]), lo(w[3]), hi(w[4]))
    rgb = [((w[3] >> s) & 0x3FF).float() * (1.0 / 256.0) for s in (20, 10, 0)]
    return (gx, gy, ca, cb, f16_unpack((w[2] >> 16) & 0xFFFF), f16_unpack(w[2] & 0xFFFF), *rgb)


def mxu_coefficients(gx, gy, ca, cb, cc):
    """The JAX kernel's per-pair coefficients (c0 .. c5) of the falloff as a
    polynomial of the pixel's coordinates, rounded as written."""
    return (-0.5 * (ca * gx * gx + cc * gy * gy) - cb * gx * gy, ca * gx + cb * gy,
            cc * gy + cb * gx, -0.5 * ca, -cb, -0.5 * cc)


def blend_tiles_plain(tile_starts, attrs, grid_x: int, grid_y: int,
                      tile_size: int = 16, max_k: int = 1024,
                      payload_format: str = "f32", mxu_power: bool = False):
    """Plain PyTorch version of K3: vectorised over (tiles, pixels, pairs),
    chunked over tiles, in any payload format. -> (accum (T, P, 3), trans
    (T, P))."""
    blend_form(payload_format, mxu_power)
    dev = attrs.device
    T = grid_x * grid_y
    P = tile_size * tile_size
    local = payload_format in PACKED
    starts = tile_starts[:-1].long()
    counts = torch.clamp(tile_starts[1:].long() - starts, max=max_k)
    p = torch.arange(P, device=dev)
    accum = torch.zeros((T, P, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((T, P), dtype=torch.float32, device=dev)
    for t0 in range(0, T, PLAIN_TILES_PER_CHUNK):
        t1 = min(T, t0 + PLAIN_TILES_PER_CHUNK)
        cnt = counts[t0:t1]
        K = int(cnt.max()) if cnt.numel() else 0
        if K == 0:
            continue
        tiles = torch.arange(t0, t1, device=dev)
        ox = 0 if local else ((tiles % grid_x) * tile_size)[:, None]
        oy = 0 if local else ((tiles // grid_x) * tile_size)[:, None]
        pixx = (ox + p % tile_size).expand(t1 - t0, P)[:, :, None].float()
        pixy = (oy + p // tile_size).expand(t1 - t0, P)[:, :, None].float()
        k = torch.arange(K, device=dev)
        valid = k[None] < cnt[:, None]                                  # (nt, K)
        idx = torch.where(valid, starts[t0:t1, None] + k[None], 0)
        f = [v[:, None, :] for v in unpack_payload(attrs[:, idx], payload_format)]
        gx, gy, ca, cb, cc, op = f[:6]
        if mxu_power:
            c0, c1, c2, c3, c4, c5 = mxu_coefficients(gx, gy, ca, cb, cc)
            power = ((((c0 + c1 * pixx) + c2 * pixy) + c3 * (pixx * pixx))
                     + c4 * (pixx * pixy)) + c5 * (pixy * pixy)
        else:
            dx = pixx - gx                                              # (nt, P, K)
            dy = pixy - gy
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=0.99)
        alpha = torch.where((power > 0.0) | (alpha < 1.0 / 255.0) | ~valid[:, None, :],
                            torch.zeros_like(alpha), alpha)
        cp = torch.cumprod(1.0 - alpha, dim=2)
        t_i = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=2)
        w = torch.where(t_i < 1e-4, torch.zeros_like(alpha), alpha * t_i)
        accum[t0:t1] = torch.einsum("tpk,tck->tpc", w, torch.cat(f[6:9], dim=1))
        trans[t0:t1] = cp[..., -1]
    return accum, trans


def blend_tiles(tile_starts: torch.Tensor, attrs: torch.Tensor, grid_x: int,
                grid_y: int, tile_size: int = 16, max_k: int = 1024,
                payload_format: str = "f32", mxu_power: bool = False):
    """Blend every tile -> (accum (T, P, 3), trans (T, P)). tile_starts
    (T+1,) int32 segment starts of the (tile, depth)-sorted pairs; attrs
    (PAYLOAD_ROWS[payload_format], Ptot) f32-bitcast words field-major
    (splat/fast_raster.py::bin_pairs). CPU tensors take the plain version,
    CUDA tensors the kernel in that form (blend_form; its own launch
    counter)."""
    form = blend_form(payload_format, mxu_power)
    if not kernel_lib.use_kernel(tile_starts, attrs):
        return blend_tiles_plain(tile_starts, attrs, grid_x, grid_y, tile_size, max_k,
                                 payload_format, mxu_power)
    lib = kernel_lib.library()
    T = grid_x * grid_y
    P = tile_size * tile_size
    if tile_size != 16:
        raise ValueError(f"tile_size {tile_size}: the kernel blends 16x16 tiles")
    kernel_lib.check(tile_starts, "tile_starts", torch.int32, (T + 1,))
    kernel_lib.check(attrs, "attrs", torch.float32)
    if attrs.shape[0] != PAYLOAD_ROWS[payload_format]:
        raise ValueError(f"attrs: expected {PAYLOAD_ROWS[payload_format]} {payload_format} "
                         f"rows, got {attrs.shape[0]}")
    out = torch.empty((T, P, 4), dtype=torch.float32, device=attrs.device)
    code = lib.ggd_blend_tiles(
        tile_starts.data_ptr(), attrs.data_ptr(), out.data_ptr(), attrs.shape[1], grid_x, T,
        tile_size, max_k, PAYLOAD_IDS[payload_format], int(mxu_power), kernel_lib.stream())
    kernel_lib.raise_on_error(code, "blend_kernel")
    attr = _launch_attr(form)
    setattr(blend_tiles, attr, getattr(blend_tiles, attr) + 1)
    return out[..., :3], out[..., 3]


# K3's launch counters, one per form (blend_form)
BLEND_FORMS = [blend_form(f, m) for f in PAYLOAD_ROWS for m in (False, True)
               if not (m and f not in PACKED)]
for _form in BLEND_FORMS:
    setattr(blend_tiles, _launch_attr(_form), 0)


# ---------------------------------------------------------------------------
# training blend: K4 forward, K5 backward (csrc/blend_train.cu)
# ---------------------------------------------------------------------------
# Kernels K4 and K5 replace the TPU kernels splat/pallas_blend.py::
# _blend_train_fwd and _blend_train_bwd_call. What bounds them on the H100:
# the serial walk per pixel through the transmittance: the train step's
# heaviest tiles hold hundreds of pairs (up to max_k), its mean tile ~45,
# and a pair of that walk is a dependent chain (the falloff, an exp, the
# cut, T). Both split the walk into chunks of ENTRY_CHUNK pairs, each
# chunk walked by warps whose lanes hold a column of pixels, and skip the
# pairs whose reach misses a warp's pixels (their alpha is 0 there). K4
# (csrc/blend_train.cu) runs one block per tile, in rounds of 8 chunks,
# and two passes a round: each chunk's local blend from T = 1 without the
# stop, (sum of weighted colours, product of (1 - alpha)); then a scan per
# pixel over the round's chunks that takes a chunk's product where T times
# it stays at least FAST_T, and replays the chunk's pairs sequentially,
# with the stop, elsewhere; no round follows one that left every pixel of
# the tile stopped. It saves each pixel's state (accum rgb, T) at the
# start of every chunk (the entries, one slot per chunk; entry_slots). K5
# replays each chunk front to back from K4's entry state with the
# forward's arithmetic, so its mask decisions are K4's, and
# reduces each pair's gradient over the tile's pixels with one warp
# reduce-scatter, no atomics.
#
# Training rule (kernels and plain versions): as the inference blend, but a
# pair blends only while the transmittance T before it is >= 1e-4; after
# that alpha is 0 and T stays (the TPU kernel's alpha mask, :228-244).
# Backward: dalpha_i = T_i (c_i . dC) - S_i / (1 - a_i) - T_final dT / (1 - a_i)
# with S_i = sum_{j > i} w_j (c_j . dC), zero where alpha was clamped
# (op exp(power) >= 0.99), skipped or masked; S_i = accum . dC - prefix_i
# from the forward's own accumulation (K5: (accum - accum_entry) . dC less
# the chunk's running sum).

def _pairs_of_tiles(tile_starts, t0, t1, max_k, dev):
    """-> (valid (nt, K), idx (nt, K)) of tiles [t0, t1): pair slots within
    each tile's min(count, max_k), idx 0 where invalid; None if empty."""
    starts = tile_starts[t0:t1].long()
    cnt = torch.clamp(tile_starts[t0 + 1:t1 + 1].long() - starts, max=max_k)
    K = int(cnt.max()) if cnt.numel() else 0
    if K == 0:
        return None
    k = torch.arange(K, device=dev)
    valid = k[None] < cnt[:, None]
    return valid, torch.where(valid, starts[:, None] + k[None], 0)


def _falloff_plain(attrs, idx, valid, tiles, grid_x, tile_size):
    """(nt, P, K) dx, dy, exp(power), raw = op exp(power), alpha (0 where
    skipped) and live; a the gathered (9, nt, K) pair fields."""
    P = tile_size * tile_size
    p = torch.arange(P, device=attrs.device)
    pixx = ((tiles % grid_x) * tile_size)[:, None] + p % tile_size
    pixy = ((tiles // grid_x) * tile_size)[:, None] + p // tile_size
    a = attrs[:, idx]
    gx, gy, ca, cb, cc, op = (a[i][:, None, :] for i in range(6))
    dx = pixx[:, :, None].float() - gx
    dy = pixy[:, :, None].float() - gy
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    e = torch.exp(power)
    raw = op * e
    alpha = torch.clamp(raw, max=0.99)
    live = (power <= 0.0) & (alpha >= 1.0 / 255.0) & valid[:, None, :]
    return a, dx, dy, e, raw, torch.where(live, alpha, torch.zeros_like(alpha)), live


def _train_mask(alpha, live):
    """Apply the T < 1e-4 stop: -> (alpha, live, T_i before each pair, T
    after all)."""
    cp0 = torch.cumprod(1.0 - alpha, dim=2)
    t_before0 = torch.cat([torch.ones_like(cp0[..., :1]), cp0[..., :-1]], dim=2)
    masked = t_before0 < 1e-4
    alpha = torch.where(masked, torch.zeros_like(alpha), alpha)
    live = live & ~masked
    cp = torch.cumprod(1.0 - alpha, dim=2)
    t_i = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=2)
    return alpha, live, t_i, cp[..., -1]


def blend_train_plain(tile_starts, attrs, grid_x: int, grid_y: int,
                      tile_size: int = 16, max_k: int = 1024):
    """Plain PyTorch version of K4 -> (accum (T, P, 3), trans (T, P))."""
    dev = attrs.device
    T, P = grid_x * grid_y, tile_size * tile_size
    accum = torch.zeros((T, P, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((T, P), dtype=torch.float32, device=dev)
    for t0 in range(0, T, PLAIN_TILES_PER_CHUNK):
        t1 = min(T, t0 + PLAIN_TILES_PER_CHUNK)
        pairs = _pairs_of_tiles(tile_starts, t0, t1, max_k, dev)
        if pairs is None:
            continue
        valid, idx = pairs
        a, _, _, _, _, alpha, live = _falloff_plain(
            attrs, idx, valid, torch.arange(t0, t1, device=dev), grid_x, tile_size)
        alpha, _, t_i, t_end = _train_mask(alpha, live)
        accum[t0:t1] = torch.einsum("tpk,ctk->tpc", alpha * t_i, a[6:9])
        trans[t0:t1] = t_end
    return accum, trans


def blend_train_bwd_plain(tile_starts, attrs, accum, trans, daccum, dtrans,
                          grid_x: int, grid_y: int, tile_size: int = 16,
                          max_k: int = 1024):
    """Plain PyTorch version of K5 -> dattrs (9, Ptot): the gradient of the
    training blend w.r.t. the sorted pair fields, given the forward's
    output (accum, trans) and its cotangents."""
    dev = attrs.device
    T = grid_x * grid_y
    dattrs = torch.zeros_like(attrs)
    for t0 in range(0, T, PLAIN_TILES_PER_CHUNK):
        t1 = min(T, t0 + PLAIN_TILES_PER_CHUNK)
        pairs = _pairs_of_tiles(tile_starts, t0, t1, max_k, dev)
        if pairs is None:
            continue
        valid, idx = pairs
        a, dx, dy, e, raw, alpha, live = _falloff_plain(
            attrs, idx, valid, torch.arange(t0, t1, device=dev), grid_x, tile_size)
        alpha, live, t_i, _ = _train_mask(alpha, live)
        dC = daccum[t0:t1]                                        # (nt, P, 3)
        cd = torch.einsum("ctk,tpc->tpk", a[6:9], dC)
        w = alpha * t_i
        prefix = torch.cumsum(w * cd, dim=2)
        s_total = (accum[t0:t1] * dC).sum(-1, keepdim=True)
        tdt = (trans[t0:t1] * dtrans[t0:t1])[..., None]
        inv1m = 1.0 / (1.0 - alpha)
        dalpha = t_i * cd - (s_total - prefix) * inv1m - tdt * inv1m
        dalpha = torch.where(live & (raw < 0.99), dalpha, torch.zeros_like(dalpha))
        dpow = dalpha * alpha
        ca, cb, cc = (a[i][:, None, :] for i in (2, 3, 4))
        g = torch.stack([
            ((ca * dx + cb * dy) * dpow).sum(1), ((cc * dy + cb * dx) * dpow).sum(1),
            (-0.5 * dx * dx * dpow).sum(1), (-dx * dy * dpow).sum(1),
            (-0.5 * dy * dy * dpow).sum(1), (dalpha * e).sum(1),
        ] + [torch.einsum("tpk,tp->tk", w, dC[..., c]) for c in range(3)])  # (9, nt, K)
        dattrs[:, idx[valid]] = g[:, valid]
    return dattrs


def _check_blend(tile_starts, attrs, grid_x, grid_y, tile_size):
    T = grid_x * grid_y
    if tile_size * tile_size != 256:
        raise ValueError(f"tile_size {tile_size}: the training kernels blend 16x16 tiles")
    kernel_lib.check(tile_starts, "tile_starts", torch.int32, (T + 1,))
    kernel_lib.check(attrs, "attrs", torch.float32)
    if attrs.shape[0] != ROWS:
        raise ValueError(f"attrs: expected {ROWS} field rows, got {attrs.shape[0]}")


def entry_slot_count(n_tiles: int, n_pairs: int, chunk: int = ENTRY_CHUNK) -> int:
    """Entry slots of K4's entries for n_tiles tiles over n_pairs sorted
    pairs: enough for every chunk of every tile."""
    return n_tiles + n_pairs // chunk + 1


def entry_slots(tile_starts, max_k: int, chunk: int = ENTRY_CHUNK):
    """-> (tile, chunk, slot) int64 of every chunk the tiles hold: tile t's
    ceil(min(count, max_k) / chunk) chunks take the slots from
    t + (start_t - start_0) // chunk on."""
    s = tile_starts.long()
    n_tiles, dev = s.shape[0] - 1, s.device
    n_chunks = (torch.clamp(s[1:] - s[:-1], min=0, max=max_k) + chunk - 1) // chunk
    tiles = torch.arange(n_tiles, device=dev)
    first = tiles + (s[:-1] - s[0]) // chunk
    tile = torch.repeat_interleave(tiles, n_chunks)
    local = (torch.arange(tile.shape[0], device=dev)
             - torch.repeat_interleave(torch.cumsum(n_chunks, 0) - n_chunks, n_chunks))
    return tile, local, first[tile] + local


def blend_train_entries_plain(tile_starts, attrs, grid_x: int, grid_y: int,
                              tile_size: int = 16, max_k: int = 1024,
                              chunk: int = ENTRY_CHUNK) -> torch.Tensor:
    """Plain version of K4's entries -> (entry_slot_count, P, 4) f32: at
    every chunk's slot, each pixel's (accum rgb, T) before the chunk's first
    pair, from the plain forward's cumulative product and sum; NaN in the
    slots no chunk takes."""
    dev = attrs.device
    T, P = grid_x * grid_y, tile_size * tile_size
    ent = torch.full((entry_slot_count(T, attrs.shape[1], chunk), P, 4), float("nan"),
                     dtype=torch.float32, device=dev)
    tile, local, slot = entry_slots(tile_starts, max_k, chunk)
    for t0 in range(0, T, PLAIN_TILES_PER_CHUNK):
        t1 = min(T, t0 + PLAIN_TILES_PER_CHUNK)
        pairs = _pairs_of_tiles(tile_starts, t0, t1, max_k, dev)
        if pairs is None:
            continue
        valid, idx = pairs
        a, _, _, _, _, alpha, live = _falloff_plain(
            attrs, idx, valid, torch.arange(t0, t1, device=dev), grid_x, tile_size)
        alpha, _, t_i, _ = _train_mask(alpha, live)
        acc = torch.cumsum((alpha * t_i)[..., None] * a[6:9].permute(1, 2, 0)[:, None], dim=2)
        acc = torch.cat([torch.zeros_like(acc[:, :, :1]), acc[:, :, :-1]], dim=2)
        sel = (tile >= t0) & (tile < t1)
        tt, kk = tile[sel] - t0, local[sel] * chunk
        ent[slot[sel]] = torch.cat([acc[tt, :, kk], t_i[tt, :, kk][..., None]], dim=2)
    return ent


def blend_train(tile_starts: torch.Tensor, attrs: torch.Tensor, grid_x: int, grid_y: int,
                tile_size: int = 16, max_k: int = 1024, entries: bool = False):
    """Training blend forward -> out (T, P, 4) f32: accumulated rgb and the
    final transmittance per pixel; with entries, (out, ent): ent (
    entry_slot_count(T, Ptot), P, 4) holds each pixel's (accum rgb, T) at
    the start of every ENTRY_CHUNK pairs of its tile (entry_slots; the
    kernel leaves the other slots unwritten), which K5 starts from. CPU
    tensors take the plain versions, CUDA tensors kernel K4."""
    if not kernel_lib.use_kernel(tile_starts, attrs):
        accum, trans = blend_train_plain(tile_starts, attrs, grid_x, grid_y, tile_size, max_k)
        out = torch.cat([accum, trans[..., None]], dim=2)
        if not entries:
            return out
        return out, blend_train_entries_plain(tile_starts, attrs, grid_x, grid_y, tile_size,
                                              max_k)
    lib = kernel_lib.library()
    _check_blend(tile_starts, attrs, grid_x, grid_y, tile_size)
    T, P = grid_x * grid_y, tile_size * tile_size
    out = torch.empty((T, P, 4), dtype=torch.float32, device=attrs.device)
    ent = torch.empty((entry_slot_count(T, attrs.shape[1]), P, 4), dtype=torch.float32,
                      device=attrs.device)
    code = lib.ggd_blend_train_fwd(
        tile_starts.data_ptr(), attrs.data_ptr(), out.data_ptr(), ent.data_ptr(),
        attrs.shape[1], grid_x, T, tile_size, max_k, ENTRY_CHUNK, kernel_lib.stream())
    kernel_lib.raise_on_error(code, "blend_train_fwd_kernel")
    blend_train.launches += 1
    return (out, ent) if entries else out


def blend_train_bwd(tile_starts: torch.Tensor, attrs: torch.Tensor, out: torch.Tensor,
                    dout: torch.Tensor, grid_x: int, grid_y: int, tile_size: int = 16,
                    max_k: int = 1024, ent: torch.Tensor | None = None) -> torch.Tensor:
    """Training blend backward: out (T, P, 4) and ent from
    blend_train(..., entries=True) and out's cotangent dout -> dattrs (9,
    Ptot). CPU tensors take the plain version (which needs no ent), CUDA
    tensors kernel K5."""
    if not kernel_lib.use_kernel(tile_starts, attrs, out, dout):
        return blend_train_bwd_plain(tile_starts, attrs, out[..., :3], out[..., 3],
                                     dout[..., :3], dout[..., 3], grid_x, grid_y,
                                     tile_size, max_k)
    lib = kernel_lib.library()
    _check_blend(tile_starts, attrs, grid_x, grid_y, tile_size)
    T, P = grid_x * grid_y, tile_size * tile_size
    shape = (T, P, 4)
    kernel_lib.check(out, "out", torch.float32, shape)
    kernel_lib.check(dout, "dout", torch.float32, shape)
    if ent is None:
        raise ValueError("ent: K5 replays each chunk from K4's entries "
                         "(blend_train(..., entries=True))")
    kernel_lib.check(ent, "ent", torch.float32, (entry_slot_count(T, attrs.shape[1]), P, 4))
    dattrs = torch.zeros_like(attrs)
    code = lib.ggd_blend_train_bwd(
        tile_starts.data_ptr(), attrs.data_ptr(), out.data_ptr(), dout.data_ptr(),
        ent.data_ptr(), dattrs.data_ptr(), attrs.shape[1], grid_x, T, tile_size, max_k,
        ENTRY_CHUNK, kernel_lib.stream())
    kernel_lib.raise_on_error(code, "blend_train_bwd_kernel")
    blend_train_bwd.launches += 1
    return dattrs


blend_train.launches = 0
blend_train_bwd.launches = 0


class _BlendTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, tile_starts, grid_x, grid_y, tile_size, max_k):
        # the plain backward needs no entries
        if kernel_lib.use_kernel(tile_starts, attrs):
            out, ent = blend_train(tile_starts, attrs, grid_x, grid_y, tile_size, max_k, True)
        else:
            out, ent = blend_train(tile_starts, attrs, grid_x, grid_y, tile_size, max_k), None
        ctx.save_for_backward(tile_starts, attrs, out, ent)
        ctx.geom = (grid_x, grid_y, tile_size, max_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        tile_starts, attrs, out, ent = ctx.saved_tensors
        dattrs = blend_train_bwd(tile_starts, attrs, out, dout.contiguous(), *ctx.geom, ent)
        return dattrs, None, None, None, None, None


def blend_tiles_diff(tile_starts: torch.Tensor, attrs: torch.Tensor, grid_x: int,
                     grid_y: int, tile_size: int = 16, max_k: int = 1024):
    """Differentiable training blend -> (accum (T, P, 3), trans (T, P)):
    forward K4, backward K5 (plain versions on the CPU). attrs (9, Ptot) f32
    field-major in (tile, depth) order; its gradient flows back through
    whatever gathered it."""
    out = _BlendTrain.apply(attrs.contiguous(), tile_starts, grid_x, grid_y, tile_size, max_k)
    return out[..., :3], out[..., 3]
