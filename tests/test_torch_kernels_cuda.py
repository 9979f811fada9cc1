"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. They import
no jax, so on a machine without it they run with the repository's
conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu_torch import flagship
from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
from gaussian_gan_decoder_tpu_torch.models.stylegan2 import MappingNetwork
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
    build_plane_table, build_slab_volume, sample_from_planes, sample_fused_inputs)
from gaussian_gan_decoder_tpu_torch.splat import fast_raster, pallas_blend
from _blend_train_cases import boundary_tiles

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("batch,c_dim,width", [
    (1, 25, 96), (3, 25, 96), (2, 0, 96), (8, 25, 96), (4, 25, 96), (2, 25, 97),
    (1, 25, 512), (4, 25, 512), (2, 25, 1536)])
def test_mapping_kernel(cuda, batch, c_dim, width):
    """K1 against its plain version, with a random camera at every width.
    Width 96 runs 48 blocks of 2 columns (4-byte copies), 97 97 blocks of 1
    (plain loads), the flagship's 512 (z 512, c 25, 8 layers) 128 blocks of
    4 (8-byte copies); at 1536 the weight columns pass shared memory and are
    read from device memory. Batch 4 is the frame stream's batch, 8 the most
    the kernel takes. Both sides take every sum in float64 (exact products,
    so the order of the sums does not show) and round it to f32 at the same
    points, so they agree to the last bit or nearly; with f32 sums the
    flagship chain carried the two orders' difference through its bf16
    roundings to ~3e-3. Two launches give the same bits (fixed-order
    sums)."""
    g = torch.Generator().manual_seed(batch)
    z_dim = 64 if width < 512 else 512
    mn = MappingNetwork(z_dim, c_dim, width, num_ws=5, generator=g)
    with torch.no_grad():
        mn.w_avg.normal_(generator=g)
    fm = pallas_mapping.fold_mapping(mn.to(cuda))
    z = torch.randn(batch, z_dim, generator=g).to(cuda)
    c = torch.randn(batch, c_dim, generator=g).to(cuda) if c_dim else None
    out = pallas_mapping.mapping_forward(z, c, fm, 0.7)[:, 0]
    again = pallas_mapping.mapping_forward(z, c, fm, 0.7)[:, 0]
    ref = pallas_mapping.mapping_forward_plain(z, c, fm, 0.7)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-3
    assert torch.equal(out, again)


def _small_frame(cuda, block=256):
    g = torch.Generator().manual_seed(0)
    gen = TriPlaneGenerator(z_dim=32, c_dim=25, w_dim=32, img_resolution=64,
                            channel_base=512, channel_max=32,
                            rendering_kwargs={"triplane_size": 32}, generator=g)
    dec = GaussianDecoder(gen, rng=g).to(cuda)
    pos = ((np.random.RandomState(1).rand(3000, 3) - 0.5) * 0.4).astype(np.float32)
    ctx = dec.make_slab_context(pos, block=block, device=cuda)
    cam = make_camera(64, 0.227, flagship.default_camera_params()[1], device=cuda)
    planes = torch.randn(1, 3, 96, 32, 32, generator=g).to(cuda)
    vol, scales = build_slab_volume(planes, 3)
    return dec.fold(), ctx, cam, vol, scales


def _hold_decode_rows(rows, ref, real, chain, cam):
    """A decode kernel's rows against its plain version's on the real
    columns (chip_smoke.py's K2 checks and limits, where their reasons are
    given)."""
    cb = pallas_heads.PROJ_ROWS["conic_b"]
    cont = [r for r in list(range(14)) + list(range(16, 26)) if r != cb]
    err = (rows - ref)[:, real].abs().amax(dim=1) / ref[:, real].abs().amax(dim=1).clamp(min=1e-3)
    assert float(err[cont].max()) <= 1e-2
    # conic_b, the near-cancelling off-diagonal, at its own scale ...
    assert float(err[cb]) <= 2e-2
    # ... and every screen row is the plain projection of the kernel's own
    # head rows, at f32 rounding
    proj = pallas_heads.project_heads(rows[:16].t(), chain, cam)
    perr = ((rows - proj)[16:26][:, real].abs().amax(dim=1)
            / proj[16:26][:, real].abs().amax(dim=1).clamp(min=1e-3))
    assert float(perr.max()) <= 1e-3
    vis = pallas_heads.PROJ_ROWS["visible"]
    assert float(((rows[vis] > 0.5) == (ref[vis] > 0.5))[real].float().mean()) >= 0.999
    assert bool(torch.isfinite(rows).all())
    assert not bool((rows[vis, ~real] > 0.5).any())


@pytest.mark.parametrize("block", [256, 64])
def test_slab_decode_kernel(cuda, block):
    """K2 against its plain version. With 64-slot slab blocks this template
    packs to Mpad 3008, so the kernel's last 128-point block is half past
    Mpad and its slab block holds 8 pad slots."""
    w, ctx, cam, vol, scales = _small_frame(cuda, block)
    if block == 64:
        assert ctx.aux.shape[0] % pallas_heads.POINTS_PER_BLOCK == 64
    rows = pallas_heads.decode_project_slab(w.chain, vol, scales, ctx, cam)
    ref = pallas_heads.decode_project_slab_plain(w.chain, vol, scales, ctx, cam)
    torch.cuda.synchronize()
    _hold_decode_rows(rows, ref, ctx.valid > 0, w.chain, cam)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 32, 3, 16, 16), (2, 32, 2, 21, 13)])
def test_brick_table_kernel(cuda, dtype, shape):
    """K10 against its plain version: bit-exact, the rows y0 > H included."""
    g = torch.Generator().manual_seed(shape[3])
    feats = (torch.randn(shape, generator=g) * 30).to(dtype).to(cuda)
    e, NY = pallas_expand.build_brick_table(feats)
    ref = pallas_expand.brick_table_plain(pallas_expand.padded_channels_last(feats), NY)
    assert pallas_expand.brick_table.launches > 0
    torch.cuda.synchronize()
    assert e.dtype == dtype and e.shape == ref.shape
    assert torch.equal(e.view(torch.uint8), ref.view(torch.uint8))


def _small_brick(cuda):
    g = torch.Generator().manual_seed(2)
    gen = TriPlaneGenerator(z_dim=32, c_dim=25, w_dim=32, img_resolution=64,
                            channel_base=512, channel_max=32,
                            rendering_kwargs={"triplane_size": 32}, generator=g)
    dec = GaussianDecoder(gen, gelu="poly", rng=g).to(cuda)
    pos = torch.tensor(((np.random.RandomState(3).rand(3000, 3) - 0.5) * 0.5)
                       .astype(np.float32), device=cuda)
    cam = make_camera(64, 0.227, flagship.default_camera_params()[1], device=cuda)
    planes = torch.randn(1, 3, 96, 32, 32, generator=g).to(cuda)
    table = build_plane_table(planes, 3, brick_dtype=torch.int8)
    return dec, dec.fold().chain, pos, cam, planes, table


def test_brick_decode_kernel(cuda):
    """K8 against its plain version on the table-sampled staging."""
    dec, cw, pos, cam, planes, table = _small_brick(cuda)
    feats = sample_from_planes(dec.G.plane_axes, planes, pos[None], 1.0, 3, table=table)[0]
    staging, Mpad = pallas_heads.build_brick_staging(feats.mean(0), pos, pos)
    rows = pallas_heads.decode_project(cw, staging, cam, pos.shape[0])
    ref = pallas_heads.decode_project_plain(cw, staging, cam, pos.shape[0])
    torch.cuda.synchronize()
    _hold_decode_rows(rows, ref, torch.arange(Mpad, device=cuda) < pos.shape[0], cw, cam)


def test_fused_decode_kernel(cuda):
    """K9 against its plain version on sample_fused_inputs' rows."""
    dec, cw, pos, cam, planes, table = _small_brick(cuda)
    M = pos.shape[0]
    aux, Mpad = pallas_heads.build_brick_staging(pos.new_zeros((M, 32)), pos, pos)
    rows_in, wts, scale_rows = sample_fused_inputs(dec.G.plane_axes, planes, pos[None], 1.0, 3,
                                                   table=table, pad_to=Mpad)
    rows = pallas_heads.decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M)
    ref = pallas_heads.decode_project_fused_plain(cw, aux, rows_in, wts, scale_rows, cam, M)
    torch.cuda.synchronize()
    _hold_decode_rows(rows, ref, torch.arange(Mpad, device=cuda) < M, cw, cam)


def _small_eg3d(cuda, block=256):
    """An EG3D tri-plane decoder (depth 1, 32^2 planes of 3 x 32 channels)
    on the card, its template (some points past the planes' border), its
    slab context (the bilinear pack) and camera, and seeded planes."""
    g = torch.Generator().manual_seed(4)
    gen = TriPlaneGenerator(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, variant="eg3d",
                            channel_base=512, channel_max=32, without_sr=True,
                            rendering_kwargs={"triplane_size": 32}, generator=g)
    dec = GaussianDecoder(gen, gelu="poly", rng=g).to(cuda)
    pos_np = ((np.random.RandomState(5).rand(3000, 3) - 0.5) * 0.4).astype(np.float32)
    pos_np[:100] *= 3.0
    ctx = dec.make_slab_context(pos_np, block=block, device=cuda)
    cam = make_camera(64, 0.227, flagship.default_camera_params()[1], device=cuda)
    planes = torch.randn(1, 3, 32, 32, 32, generator=g).to(cuda)
    return dec, dec.fold().chain, torch.tensor(pos_np, device=cuda), ctx, cam, planes


@pytest.mark.parametrize("block", [256, 64])
def test_slab_decode_bilinear_kernel(cuda, block):
    """K2's bilinear form (depth-1 volume (3, 1, YP, XP*32), 4 corners a
    plane) against its plain version, with the tri-grid form's limits; pad
    slots culled. Block 64 leaves a ragged last 128-point block."""
    dec, cw, _, ctx, cam, planes = _small_eg3d(cuda, block)
    vol, scales = build_slab_volume(planes, 1)
    assert vol.shape[1] == 1 and ctx.sizes[0] == 1
    before = pallas_heads.decode_project_slab.launches
    rows = pallas_heads.decode_project_slab(cw, vol, scales, ctx, cam)
    assert pallas_heads.decode_project_slab.launches == before + 1
    ref = pallas_heads.decode_project_slab_plain(cw, vol, scales, ctx, cam)
    torch.cuda.synchronize()
    valid = ctx.valid > 0
    _hold_decode_rows(rows, ref, valid, cw, cam)
    for k in ("visible", "opac", "radius_f"):
        assert not bool(rows[pallas_heads.PROJ_ROWS[k], ~valid].any()), k


def test_fused_decode_triplane_kernel(cuda):
    """K9's tri-plane form (3 planes of (Mpad, 4 * 32) bf16 rows, scale rows
    the 1/3 plane mean) against its plain version on sample_fused_inputs'
    depth-1 inputs, with the tri-grid form's limits."""
    dec, cw, pos, _, cam, planes = _small_eg3d(cuda)
    M = pos.shape[0]
    aux, Mpad = pallas_heads.build_brick_staging(pos.new_zeros((M, 32)), pos, pos)
    rows_in, wts, scale_rows = sample_fused_inputs(dec.G.plane_axes, planes, pos[None], 1.0, 1,
                                                   pad_to=Mpad)
    assert rows_in[0].dtype == torch.bfloat16 and rows_in[0].shape == (Mpad, 128)
    before = pallas_heads.decode_project_fused.launches
    rows = pallas_heads.decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M)
    assert pallas_heads.decode_project_fused.launches == before + 1
    ref = pallas_heads.decode_project_fused_plain(cw, aux, rows_in, wts, scale_rows, cam, M)
    torch.cuda.synchronize()
    _hold_decode_rows(rows, ref, torch.arange(Mpad, device=cuda) < M, cw, cam)


def test_blend_kernel(cuda):
    w, ctx, cam, vol, scales = _small_frame(cuda)
    rows = pallas_heads.decode_project_slab_plain(w.chain, vol, scales, ctx, cam)
    starts, attrs = fast_raster.bin_pairs(rows, 4, 4, 16)
    for max_k in (640, 7):
        acc, tr = pallas_blend.blend_tiles(starts, attrs, 4, 4, 16, max_k)
        acc_p, tr_p = pallas_blend.blend_tiles_plain(starts, attrs, 4, 4, 16, max_k)
        torch.cuda.synchronize()
        assert float((acc - acc_p).abs().max()) <= 1e-4
        assert float((tr - tr_p).abs().max()) <= 1e-4


def _train_pairs(seed, grid=4, max_k=96):
    """Depth-ordered per-tile pairs over a (16 grid)^2 image: one tile past
    max_k, one of near-opaque pairs that saturate, peak alphas that clamp."""
    rng = np.random.RandomState(seed)
    T = grid * grid
    counts = rng.randint(5, 300, size=T)
    counts[1], counts[2] = max_k + 200, 0
    cols = []
    for t in range(T):
        n = counts[t]
        ox, oy = (t % grid) * 16, (t // grid) * 16
        s = rng.uniform(1.5, 7.0, (2, n))
        rho = rng.uniform(-0.6, 0.6, n)
        det = (s[0] * s[1]) ** 2 * (1 - rho ** 2)
        op = rng.uniform(0.05, 0.95, n)
        op[rng.rand(n) < 0.15] = 0.999
        if t == 5:
            op[:] = 0.98
        cols.append(np.stack([ox + rng.uniform(-4, 20, n), oy + rng.uniform(-4, 20, n),
                              s[1] ** 2 / det, -rho * s[0] * s[1] / det, s[0] ** 2 / det, op,
                              *rng.uniform(0, 1.2, (3, n))]))
    attrs = np.concatenate(cols, axis=1).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return starts, attrs


@pytest.mark.parametrize("max_k", [96, 1024])
def test_blend_train_kernels(cuda, max_k):
    """K4 and K5 against blend_train_plain / blend_train_bwd_plain: outputs
    within 1e-5, pair gradients within 1e-3 of each field's largest (the
    plain version's cumulative products round in another order)."""
    st, at = _train_pairs(0, max_k=max_k)
    starts, attrs = torch.tensor(st, device=cuda), torch.tensor(at, device=cuda)
    out, ent = pallas_blend.blend_train(starts, attrs, 4, 4, 16, max_k, entries=True)
    acc_p, tr_p = pallas_blend.blend_train_plain(starts, attrs, 4, 4, 16, max_k)
    torch.cuda.synchronize()
    assert float((out[..., :3] - acc_p).abs().max()) <= 1e-5
    assert float((out[..., 3] - tr_p).abs().max()) <= 1e-5
    g = torch.Generator(device="cpu").manual_seed(1)
    dout = torch.randn(out.shape, generator=g).to(cuda)
    d_k = pallas_blend.blend_train_bwd(starts, attrs, out, dout, 4, 4, 16, max_k, ent)
    d_p = pallas_blend.blend_train_bwd_plain(starts, attrs, acc_p, tr_p, dout[..., :3],
                                             dout[..., 3], 4, 4, 16, max_k)
    torch.cuda.synchronize()
    err = (d_k - d_p).abs().amax(dim=1) / d_p.abs().amax(dim=1).clamp(min=1e-12)
    assert float(err.max()) <= 1e-3, err.tolist()
    assert bool(torch.isfinite(d_k).all())


def _step_pairs(seed, grid_x, grid_y, heavy, saturate):
    """Per-tile pairs shaped as the train step's: one tile of `heavy`
    pairs, the rest light, among them an empty tile and tiles of C - 1, C,
    C + 1 and 2C + 1 pairs (C the training chunk, pallas_blend.ENTRY_CHUNK).
    saturate: wide Gaussians of opacity 0.6-1, so that most pixels fall
    below T 1e-4."""
    rng = np.random.RandomState(seed)
    C, T = pallas_blend.ENTRY_CHUNK, grid_x * grid_y
    counts = rng.randint(3, 60, size=T)
    counts[:6] = [heavy, 0, C - 1, C, C + 1, 2 * C + 1]
    counts = counts[rng.permutation(T)]
    cols = []
    for t in range(T):
        n = counts[t]
        ox, oy = (t % grid_x) * 16, (t // grid_x) * 16
        s = rng.uniform(4.0, 12.0, (2, n)) if saturate else rng.uniform(1.0, 6.0, (2, n))
        rho = rng.uniform(-0.6, 0.6, n)
        det = (s[0] * s[1]) ** 2 * (1 - rho ** 2)
        op = rng.uniform(0.6, 1.0, n) if saturate else rng.uniform(0.05, 0.95, n)
        op[rng.rand(n) < 0.1] = 0.999
        cols.append(np.stack([ox + rng.uniform(-4, 20, n), oy + rng.uniform(-4, 20, n),
                              s[1] ** 2 / det, -rho * s[0] * s[1] / det, s[0] ** 2 / det, op,
                              *rng.uniform(0, 1.2, (3, n))]))
    attrs = np.concatenate(cols, axis=1).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return torch.tensor(starts), torch.tensor(attrs)


def _hold_pixels(a, b, tol, limit):
    """chip_smoke.py's blend checks: 99.9 % of pixels within tol, none past
    limit (a pixel whose T crosses 1e-4 at another pair in the plain
    version's cumulative product differs by that pair's weight)."""
    d = (a - b).abs().amax(dim=-1)
    assert float((d <= tol).float().mean()) >= 0.999 and float(d.max()) <= limit, float(d.max())


@pytest.mark.parametrize("saturate", [False, True])
def test_blend_kernel_step_shape(cuda, saturate):
    """K3 against blend_tiles_plain at its cap 640, on a ragged 5 x 3 tile
    grid with one tile past the cap, an empty tile and chunk-boundary
    counts."""
    starts, attrs = (x.to(cuda) for x in _step_pairs(3, 5, 3, 700, saturate))
    acc, tr = pallas_blend.blend_tiles(starts, attrs, 5, 3, 16, 640)
    acc_p, tr_p = pallas_blend.blend_tiles_plain(starts, attrs, 5, 3, 16, 640)
    torch.cuda.synchronize()
    _hold_pixels(torch.cat([acc, tr[..., None]], 2), torch.cat([acc_p, tr_p[..., None]], 2),
                 1e-4, 1e-2)


@pytest.mark.parametrize("saturate", [False, True])
def test_blend_train_kernels_step_shape(cuda, saturate):
    """K4 (with its chunk entries) and K5 against their plain versions at
    max_k 1024, on a ragged 5 x 4 tile grid: 5 x 3 tiles with one at max_k,
    an empty tile and chunk-boundary counts, and a row of the boundary
    cases of K4's scan (_blend_train_cases: a stop at the last and at the
    first pair of a chunk, T P_c inside the margin, a product that
    underflows, a product and a fold on either side of 1e-4). Outputs and
    entries as chip_smoke.py holds them (99.9 % of pixels within 1e-5, max
    1e-3), the boundary row's stops where they were built, gradients within
    1e-3 of each field's largest with zero-gradient agreement >= 0.999; two
    K4 launches and two K5 launches give the same bits."""
    st, at = _step_pairs(4, 5, 3, 1100, saturate)
    rows = boundary_tiles([(16 * t, 48) for t in range(5)], np.random.RandomState(6))
    attrs = torch.cat([at, torch.tensor(np.concatenate(list(rows.values()), axis=1))], dim=1)
    counts = torch.tensor([r.shape[1] for r in rows.values()])
    starts = torch.cat([st, st[-1] + torch.cumsum(counts, 0).int()])
    starts, attrs = starts.to(cuda), attrs.to(cuda)
    out, ent = pallas_blend.blend_train(starts, attrs, 5, 4, 16, 1024, entries=True)
    out_2, ent_2 = pallas_blend.blend_train(starts, attrs, 5, 4, 16, 1024, entries=True)
    acc_p, tr_p = pallas_blend.blend_train_plain(starts, attrs, 5, 4, 16, 1024)
    ent_p = pallas_blend.blend_train_entries_plain(starts, attrs, 5, 4, 16, 1024)
    _, _, slot = pallas_blend.entry_slots(starts, 1024)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    d_k = pallas_blend.blend_train_bwd(starts, attrs, out, dout, 5, 4, 16, 1024, ent)
    d_2 = pallas_blend.blend_train_bwd(starts, attrs, out, dout, 5, 4, 16, 1024, ent)
    d_p = pallas_blend.blend_train_bwd_plain(starts, attrs, acc_p, tr_p, dout[..., :3],
                                             dout[..., 3], 5, 4, 16, 1024)
    torch.cuda.synchronize()
    assert torch.equal(out, out_2) and torch.equal(ent[slot], ent_2[slot])
    _hold_pixels(out, torch.cat([acc_p, tr_p[..., None]], 2), 1e-5, 1e-3)
    assert not bool(torch.isnan(ent_p[slot]).any())
    _hold_pixels(ent[slot], ent_p[slot], 1e-5, 1e-3)
    # the boundary row: "last", "first" and "margin" stop every pixel at
    # pair 31, 128 and 32, so the pairs after those get no gradient and
    # the pairs up to them do; "straddle" at its last pair, T below 1e-4
    ends = starts[15:].long().tolist()
    for t, stop in ((0, 31), (1, 128), (2, 32)):
        first = ends[t]
        assert bool((d_k[:, first + stop + 1:ends[t + 1]] == 0).all())
        assert bool((d_k[5:, first:first + stop + 1] != 0).all())
    assert bool((out[19, :, 3] < 1e-4).all())
    if saturate:
        assert float((out[:15, :, 3] < 1e-4).float().mean()) >= 0.3
    assert torch.equal(d_k, d_2)
    assert bool(torch.isfinite(d_k).all())
    err = (d_k - d_p).abs().amax(dim=1) / d_p.abs().amax(dim=1).clamp(min=1e-12)
    assert float(err.max()) <= 1e-3, err.tolist()
    zero_agree = ((d_k == 0).all(dim=0) == (d_p == 0).all(dim=0)).float().mean()
    assert float(zero_agree) >= 0.999


@pytest.mark.parametrize("M", [16384 + 64, 8192 + 32])
def test_heads_train_kernels(cuda, M):
    """K6 and K7 against decode_heads_plain / decode_heads_bwd_plain on the
    exact-GELU sequential_reversed chain: outputs within 1e-5 and gradients
    within 1e-4 of their max (3xTF32 on the tensor cores: summation order
    only). 16448 points give K7 more 64-point tiles than blocks; 8224 end in
    a half tile of K7 and a quarter block of K6 (128 points), masked inside
    both. Two launches
    of K7 give bit-identical results (fixed-order partial sums, no atomics)."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads_vjp

    cw, st = _train_chain(cuda, M, "exact")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        out = pallas_heads.decode_heads(st, cw)
        ref = pallas_heads.decode_heads_plain(st, cw)
        dout = torch.randn(M, 16, generator=g).to(cuda)
        dst, grads = pallas_heads_vjp.decode_heads_bwd(st, out, dout, cw)
        dst2, grads2 = pallas_heads_vjp.decode_heads_bwd(st, out, dout, cw)
        dst_p, grads_p = pallas_heads_vjp.decode_heads_bwd_plain(st, ref, dout, cw)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert float((dst - dst_p).abs().max() / dst_p.abs().max()) <= 1e-4
    for a, b in zip(grads, grads_p):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    assert torch.equal(dst, dst2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("gelu", ["tanh", "poly", "poly6", "none"])
def test_heads_fwd_gelu_kinds(cuda, gelu):
    """K6 with every other GELU the chain takes (the train step uses the
    exact one), on a ragged 1000-point staging, within 1e-5 of its max."""
    cw, st = _train_chain(cuda, 1000, gelu)
    with torch.no_grad():
        out = pallas_heads.decode_heads(st, cw)
        ref = pallas_heads.decode_heads_plain(st, cw)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5


def _train_chain(cuda, M, gelu):
    """The sequential_reversed chain with seeded heads and an (M, 128) f32
    staging of seeded features and positions."""
    from gaussian_gan_decoder_tpu_torch.decoder.heads import CHAIN, DecoderHead

    g = torch.Generator().manual_seed(0)
    heads, cond = {}, 3
    for name, od in CHAIN:
        heads[name] = DecoderHead(32 + cond, od, generator=g).to(cuda)
        cond += od
    feats = (torch.randn(M, 32, generator=g) * 2).to(cuda)
    pos = (torch.rand(M, 3, generator=g) - 0.5).to(cuda)
    with torch.no_grad():
        cw = pallas_heads.pack_chain_f32(heads, CHAIN, 3, -2.5, gelu)
        st = pallas_heads.build_staging_f32(feats, pos, pos)
    return cw, st
