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
from gaussian_gan_decoder_tpu_torch.decoder.heads import DecoderHead, GaussianDecoder
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
from gaussian_gan_decoder_tpu_torch.models.stylegan2 import MappingNetwork
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
    _quantize_int8, build_plane_table, build_slab_volume, sample_from_planes,
    sample_fused_inputs)
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
    dec = GaussianDecoder(gen, rng=g, pallas_heads=True, heads_bf16=True).to(cuda)
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
    dec = GaussianDecoder(gen, gelu="poly", rng=g, pallas_heads=True,
                          heads_bf16=True).to(cuda)
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
    dec = GaussianDecoder(gen, gelu="poly", rng=g, pallas_heads=True,
                          heads_bf16=True).to(cuda)
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


# ---- the decoder's other types and options: the f32 decode tails (K2, K8,
# K9 at f32), K6's bf16 form, and the parallel chain's write-back guard ----

def _radius_continuous(rows):
    """3 sqrt(lambda_max) of the 2D covariance that the conic rows invert,
    in f64: the value whose ceiling is the radius row."""
    pr = pallas_heads.PROJ_ROWS
    a, b, c = (rows[pr[k]].double() for k in ("conic_a", "conic_b", "conic_c"))
    inv_det = a * c - b * b
    cov_a, cov_b, cov_c = c / inv_det, -b / inv_det, a / inv_det
    mid = 0.5 * (cov_a + cov_c)
    det = cov_a * cov_c - cov_b * cov_b
    return 3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1)))


def _hold_f32_rows(rows, ref, real, chain, cam):
    """An f32 decode kernel's rows (3xTF32 chain, csrc/decode_f32.cu)
    against its plain version's: f32 up to the chain's summation order, so
    the raw head rows 0:14 and the continuous screen rows within 1e-4 of
    each row's scale on the real columns (conic_b, the near-cancelling
    off-diagonal, within 1e-3 of its own); the radius's continuous value
    3 sqrt(lambda_max) (from the conic rows) within 1e-4 of its scale too,
    so the radius is exact wherever the plain version's value lies farther
    than that from an integer, and within one pixel everywhere; every
    screen row the plain projection of the kernel's own head rows at 1e-4;
    visibility agreement >= 0.999; rows 14:16 and 28: zero; pad columns
    not visible."""
    pr = pallas_heads.PROJ_ROWS
    cb = pr["conic_b"]
    err = (rows - ref)[:, real].abs().amax(dim=1) / ref[:, real].abs().amax(dim=1).clamp(min=1e-3)
    screen = [r for r in range(16, 26) if r != cb]
    assert float(err[:14].max()) <= 1e-4, err[:14].tolist()
    assert float(err[screen].max()) <= 1e-4, err[screen].tolist()
    assert float(err[cb]) <= 1e-3
    proj = pallas_heads.project_heads(rows[:16].t(), chain, cam)
    perr = ((rows - proj)[16:26][:, real].abs().amax(dim=1)
            / proj[16:26][:, real].abs().amax(dim=1).clamp(min=1e-3))
    assert float(perr[[r - 16 for r in screen]].max()) <= 1e-4
    rad = (rows - ref)[pr["radius_f"], real].abs()
    assert float(rad.max()) <= 1.0
    vis = pr["visible"]
    both = real & (rows[vis] > 0.5) & (ref[vis] > 0.5)
    t, t_ref = _radius_continuous(rows)[both], _radius_continuous(ref)[both]
    tol = 1e-4 * float(t_ref.abs().max())
    gap = float((t - t_ref).abs().max())
    flips = (rows - ref)[pr["radius_f"], both] != 0
    edge = (t_ref - t_ref.round()).abs() <= tol
    print(f"radius: {int(flips.sum())} of {int(both.sum())} differ, {int(edge.sum())} within "
          f"{tol:.3e} of an integer, |3 sqrt(lambda) gap| {gap:.3e} ({gap / tol:.3f} of 1e-4 "
          f"of its scale); the flips' distances "
          + str([round(float(x), 6) for x in (t_ref - t_ref.round()).abs()[flips]]))
    assert gap <= tol
    assert not bool((flips & ~edge).any())
    assert float(((rows[vis] > 0.5) == (ref[vis] > 0.5))[real].float().mean()) >= 0.999
    assert bool(torch.isfinite(rows).all())
    assert not bool(rows[14:16].any()) and not bool(rows[28:].any())
    assert not bool((rows[vis, ~real] > 0.5).any())


# (decoder_type, use_xyz_embedding, heads_bf16): the options' decoders. The
# first is D-par (the JAX GaussianDecoder's default dtype), the second holds
# the bf16 tails' write-back guard on the parallel chain (stage column 128)
OPTION_DECODERS = [("parallel", True, False), ("parallel", True, True),
                   ("sequential", False, True), ("sequential", True, False)]


def _option_frame(cuda, decoder_type, emb, bf16, variant="panohead", block=256,
                  n_points=3000, gelu="exact"):
    """A decoder of the given options on a small generator (32^2 tri-grid of
    depth 3, or an EG3D tri-plane), seeded heads with the given GELU (exact
    by default), an n_points template with its slab context, a camera and
    seeded planes."""
    g = torch.Generator().manual_seed(6)
    depth = 3 if variant == "panohead" else 1
    gen = TriPlaneGenerator(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, variant=variant,
                            channel_base=512, channel_max=32, without_sr=variant == "eg3d",
                            rendering_kwargs={"triplane_size": 32}, generator=g)
    dec = GaussianDecoder(gen, gelu=gelu, rng=g, decoder_type=decoder_type,
                          use_xyz_embedding=emb, heads_bf16=bf16).to(cuda)
    pos_np = ((np.random.RandomState(7).rand(n_points, 3) - 0.5) * 0.4).astype(np.float32)
    ctx = dec.make_slab_context(pos_np, block=block, device=cuda)
    cam = make_camera(64, 0.227, flagship.default_camera_params(device=cuda)[1], device=cuda)
    planes = torch.randn(1, 3, 32 * depth, 32, 32, generator=g).to(cuda)
    return dec, dec.fold().chain, torch.tensor(pos_np, device=cuda), ctx, cam, planes


def _route_rows(dec, cw, pos, ctx, cam, planes, route, kernel, block=pallas_heads.DECODE_BLOCK,
                lerp="bcast"):
    """One route's decode with its kernel (kernel=True) or its plain version
    -> (rows, real-column mask, the wrapper); the brick routes' staging
    padded to a multiple of block, the fused route's lerp."""
    ph = pallas_heads
    D = dec.G.triplane_depth
    dt = ph.chain_dtype(cw)
    M = pos.shape[0]
    if route == "slab":
        vol, scales = build_slab_volume(planes, D)
        fn = ph.decode_project_slab if kernel else ph.decode_project_slab_plain
        return fn(cw, vol, scales, ctx, cam), ctx.valid > 0, ph.decode_project_slab
    table = build_plane_table(planes, D, brick_dtype=torch.int8 if D > 1 else torch.bfloat16)
    cond = dec.cond0(pos)
    if route == "table":
        feats = sample_from_planes(dec.G.plane_axes, planes, pos[None], 1.0, D, table=table)[0]
        staging, Mpad = ph.build_brick_staging(feats.mean(0), cond, pos, block, dtype=dt)
        fn = ph.decode_project if kernel else ph.decode_project_plain
        return (fn(cw, staging, cam, M), torch.arange(Mpad, device=pos.device) < M,
                ph.decode_project)
    aux, Mpad = ph.build_brick_staging(pos.new_zeros((M, 32)), cond, pos, block, dtype=dt)
    rows_in, wts, scale_rows = sample_fused_inputs(dec.G.plane_axes, planes, pos[None], 1.0, D,
                                                   table=table, pad_to=Mpad)
    fn = ph.decode_project_fused if kernel else ph.decode_project_fused_plain
    return (fn(cw, aux, rows_in, wts, scale_rows, cam, M, lerp=lerp),
            torch.arange(Mpad, device=pos.device) < M, ph.decode_project_fused)


@pytest.mark.parametrize("route", ["slab", "table", "fused"])
def test_decode_kernels_decoder_options(cuda, route):
    """K2 / K8 / K9 on each option decoder against their plain versions: the
    f32 forms (csrc/decode_f32.cu) with _hold_f32_rows, the bf16 forms with
    K2's limits (the parallel chain's rows hold its write-back guard, whose
    columns 128-130 the bf16 tile's padding would hide); each launch counted
    on its own form."""
    for decoder_type, emb, bf16 in OPTION_DECODERS:
        dec, cw, pos, ctx, cam, planes = _option_frame(cuda, decoder_type, emb, bf16)
        assert pallas_heads.chain_dtype(cw) == (torch.bfloat16 if bf16 else torch.float32)
        if decoder_type == "parallel":
            assert all(sc == pallas_heads.STAGE for _, _, sc, _ in cw.chain)
        _, _, wrapper = _route_rows(dec, cw, pos, ctx, cam, planes, route, False)
        attr = "launches" if bf16 else "launches_f32"
        before = getattr(wrapper, attr)
        rows, real, _ = _route_rows(dec, cw, pos, ctx, cam, planes, route, True)
        assert getattr(wrapper, attr) == before + 1
        ref, _, _ = _route_rows(dec, cw, pos, ctx, cam, planes, route, False)
        torch.cuda.synchronize()
        (_hold_decode_rows if bf16 else _hold_f32_rows)(rows, ref, real, cw, cam)


def test_decode_f32_triplane_kernels(cuda):
    """The f32 forms of K2's bilinear form and K9's tri-plane form (4 bf16
    corners) on an EG3D tri-plane, D-par's options, against their plain
    versions (_hold_f32_rows); a 64-slot slab block leaves a ragged last
    128-point block."""
    dec, cw, pos, ctx, cam, planes = _option_frame(cuda, "parallel", True, False, "eg3d", 64)
    for route in ("slab", "fused"):
        rows, real, _ = _route_rows(dec, cw, pos, ctx, cam, planes, route, True)
        ref, _, _ = _route_rows(dec, cw, pos, ctx, cam, planes, route, False)
        torch.cuda.synchronize()
        _hold_f32_rows(rows, ref, real, cw, cam)


def test_heads_bf16_kernel(cuda):
    """K6's bf16 form (csrc/heads_bf16.cu) against decode_heads_plain on a
    bf16 chain, for every decoder type with and without the xyz embedding,
    on a ragged 1000-point staging: each output column within 1e-2 of its
    scale (K2's limit: bf16 flips of the chain's summation order); the
    columns past the chain's 14 zero."""
    for decoder_type in ("sequential_reversed", "sequential", "parallel"):
        for emb in (False, True):
            dec, cw, pos, _, _, planes = _option_frame(cuda, decoder_type, emb, True)
            feats = torch.randn(pos.shape[0], 32, generator=torch.Generator().manual_seed(8))
            staging, _ = pallas_heads.build_brick_staging(
                feats.to(cuda), dec.cond0(pos), pos, block=1000, dtype=torch.bfloat16)
            before = pallas_heads.decode_heads.launches_bf16
            out = pallas_heads.decode_heads(staging, cw)
            assert pallas_heads.decode_heads.launches_bf16 == before + 1
            ref = pallas_heads.decode_heads_plain(staging, cw)
            torch.cuda.synchronize()
            err = (out - ref)[:, :14].abs().amax(dim=0) / ref[:, :14].abs().amax(dim=0)
            assert float(err.max()) <= 1e-2, (decoder_type, emb, err.tolist())
            assert not bool(out[:, 14:].any())


def test_heads_train_kernels_parallel_embedding(cuda):
    """K6 and K7 on the parallel chain with the xyz embedding (P = 63: the
    heads read 95 staging columns, none written back) against their plain
    versions at the limits of test_heads_train_kernels."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads_vjp

    dec, _, pos, _, _, _ = _option_frame(cuda, "parallel", True, False)
    M = pos.shape[0]
    g = torch.Generator().manual_seed(9)
    feats = (torch.randn(M, 32, generator=g) * 2).to(cuda)
    with torch.no_grad():
        cw = pallas_heads.pack_chain_f32(dec.heads(), dec.chain_spec, dec.position_dim,
                                         dec.scale_offset, "exact", parallel=True)
        st = pallas_heads.build_staging_f32(feats, dec.cond0(pos), pos)
        out = pallas_heads.decode_heads(st, cw)
        ref = pallas_heads.decode_heads_plain(st, cw)
        dout = torch.randn(M, 16, generator=g).to(cuda)
        dst, grads = pallas_heads_vjp.decode_heads_bwd(st, out, dout, cw)
        dst_p, grads_p = pallas_heads_vjp.decode_heads_bwd_plain(st, ref, dout, cw)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert float((dst - dst_p).abs().max() / dst_p.abs().max()) <= 1e-4
    for a, b in zip(grads, grads_p):
        assert float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)) <= 1e-4


def test_blend_kernel_payload_forms(cuda):
    """K3 in every payload form (f32, bf16_colors, packed_v2, packed_v3, the
    packed two with mxu_power) against its plain version on the same binned
    words, on a small frame's pairs and on them widened (conic / 16,
    opacity raised) until pixels saturate, at max_k 640 and 7; each launch
    counted on its form's own counter."""
    from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig

    w, ctx, cam, vol, scales = _small_frame(cuda)
    rows = pallas_heads.decode_project_slab_plain(w.chain, vol, scales, ctx, cam)
    wide = rows.clone()
    pr = pallas_heads.PROJ_ROWS
    wide[pr["conic_a"]:pr["conic_c"] + 1] /= 16.0
    wide[pr["radius_f"]] *= 4.0
    wide[pr["opac"]] = 0.6 + 0.4 * wide[pr["opac"]]
    forms = [("f32", False), ("bf16_colors", False), ("packed_v2", False),
             ("packed_v3", False), ("packed_v2", True), ("packed_v3", True)]
    for src in (rows, wide):
        for fmt, mxu in forms:
            cfg = RasterizeConfig(bf16_colors=fmt == "bf16_colors",
                                  packed_payloads=fmt.startswith("packed"),
                                  rgb10_payloads=fmt == "packed_v3",
                                  fused_sort_key=fmt.startswith("packed"), blend_mxu_power=mxu)
            starts, attrs = fast_raster.bin_pairs(src, 4, 4, 16, cfg)
            assert attrs.shape[0] == pallas_blend.PAYLOAD_ROWS[fmt]
            attr = ("launches" if fmt == "f32"
                    else f"launches_{pallas_blend.blend_form(fmt, mxu)}")
            for max_k in (640, 7):
                before = getattr(pallas_blend.blend_tiles, attr)
                acc, tr = pallas_blend.blend_tiles(starts, attrs, 4, 4, 16, max_k,
                                                   payload_format=fmt, mxu_power=mxu)
                assert getattr(pallas_blend.blend_tiles, attr) == before + 1
                acc_p, tr_p = pallas_blend.blend_tiles_plain(starts, attrs, 4, 4, 16, max_k,
                                                             payload_format=fmt, mxu_power=mxu)
                torch.cuda.synchronize()
                err = max(float((acc - acc_p).abs().max()), float((tr - tr_p).abs().max()))
                assert err <= 1e-4, (fmt, mxu, max_k, err)


def test_fused_decode_dots_kernels(cuda):
    """K9's 'dots' lerp in its four forms (8 int8 / 4 bf16 corners, bf16 /
    f32 chain) against its plain version on sample_fused_inputs' rows;
    the bf16 forms' rows bit-identical to K8's on the staging of
    the plain 'dots' features (the lerp witness); each launch counted on
    launches_dots / launches_dots_f32."""
    ph = pallas_heads
    b = _small_brick(cuda)
    cases = [(b[0], b[1], b[2], b[3], b[4], 3)]
    for build, D in ((lambda: _small_eg3d(cuda), 1),
                     (lambda: _option_frame(cuda, "parallel", True, False), 3),
                     (lambda: _option_frame(cuda, "parallel", True, False, "eg3d"), 1)):
        dec, cw, pos, _, cam, planes = build()
        cases.append((dec, cw, pos, cam, planes, D))
    for dec, cw, pos, cam, planes, D in cases:
        M = pos.shape[0]
        dt = ph.chain_dtype(cw)
        cond = dec.cond0(pos)
        aux, Mpad = ph.build_brick_staging(pos.new_zeros((M, 32)), cond, pos, dtype=dt)
        rows_in, wts, scale_rows = sample_fused_inputs(dec.G.plane_axes, planes, pos[None],
                                                       1.0, D, pad_to=Mpad)
        attr = "launches_dots" if dt == torch.bfloat16 else "launches_dots_f32"
        before = getattr(ph.decode_project_fused, attr)
        rows = ph.decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M, lerp="dots")
        assert getattr(ph.decode_project_fused, attr) == before + 1
        ref = ph.decode_project_fused_plain(cw, aux, rows_in, wts, scale_rows, cam, M,
                                            lerp="dots")
        torch.cuda.synchronize()
        real = torch.arange(Mpad, device=cuda) < M
        if dt == torch.bfloat16:
            _hold_decode_rows(rows, ref, real, cw, cam)
            feats = ph.fused_features_plain(rows_in, wts, scale_rows, "dots")[:M]
            st, _ = ph.build_brick_staging(feats, cond, pos, dtype=dt)
            assert torch.equal(rows, ph.decode_project(cw, st, cam, M)), (D, "witness")
        else:
            _hold_f32_rows(rows, ref, real, cw, cam)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_brick_table_select_kernel(cuda, dtype):
    """K10's select form (the duplicated source) against its plain version
    and against K10's rotate table: byte for byte, the rows y0 > H
    included; counted on brick_table_select.launches."""
    for shape in ((3, 32, 3, 16, 16), (2, 32, 2, 21, 13), (2, 16, 2, 9, 7)):
        g = torch.Generator().manual_seed(shape[3])
        feats = (torch.randn(shape, generator=g) * 30).to(dtype).to(cuda)
        before = pallas_expand.brick_table_select.launches
        e, NY = pallas_expand.build_brick_table(feats, select=True)
        assert pallas_expand.brick_table_select.launches == before + 1
        rot, _ = pallas_expand.build_brick_table(feats)
        ref = pallas_expand.brick_table_select_plain(
            pallas_expand.duplicated_channels_last(feats), NY, shape[1])
        torch.cuda.synchronize()
        assert torch.equal(e.view(torch.uint8), ref.view(torch.uint8))
        assert torch.equal(e.view(torch.uint8), rot.view(torch.uint8))


# ---- the f32 decode kernels over many tiles (csrc/decode_f32.cu: a
# 128-point block a tile, the chain then the tile's head rows; the
# projection kernel over every point after it) ----

F32_FORMS = [("slab", "panohead", "bcast"), ("slab", "eg3d", "bcast"),
             ("table", "panohead", "bcast"), ("fused", "panohead", "bcast"),
             ("fused", "panohead", "dots"), ("fused", "eg3d", "bcast"),
             ("fused", "eg3d", "dots")]


@pytest.mark.parametrize("route,variant,lerp", F32_FORMS)
def test_decode_f32_many_tiles(cuda, route, variant, lerp):
    """Each f32 decode form on D-par's options over 40,000 points: 313 tiles
    of 128, more than the card's SMs and not a multiple of them, the last
    ragged (64 rows); held against its plain version (_hold_f32_rows), and
    a second launch bit-identical to the first (a tile's rows do not depend
    on the order its blocks run in)."""
    dec, cw, pos, ctx, cam, planes = _option_frame(cuda, "parallel", True, False, variant,
                                                   block=64, n_points=40_000)
    rows, real, _ = _route_rows(dec, cw, pos, ctx, cam, planes, route, True, 32, lerp)
    again, _, _ = _route_rows(dec, cw, pos, ctx, cam, planes, route, True, 32, lerp)
    ref, _, _ = _route_rows(dec, cw, pos, ctx, cam, planes, route, False, 32, lerp)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_tiles = -(-rows.shape[1] // 128)
    assert n_tiles > sms and n_tiles % sms and rows.shape[1] % 128 == 64, (n_tiles, sms)
    assert torch.equal(rows, again)
    _hold_f32_rows(rows, ref, real, cw, cam)


@pytest.mark.parametrize("gelu", ["exact", "tanh", "poly", "poly6", "none"])
def test_decode_f32_gelu_kinds_and_heads(cuda, gelu):
    """K8-f32 with each GELU kind (a template argument: one kernel instance
    a kind) on 3,000 points (24 tiles, fewer than the card's SMs, the last
    ragged), with the decoder's 5 heads and with a chain of 1 head (14
    outputs, projected from its columns); held against the plain version,
    two launches bit-identical."""
    ph = pallas_heads
    dec, cw, pos, _, cam, planes = _option_frame(cuda, "sequential_reversed", False, False,
                                                 gelu=gelu)
    g = torch.Generator().manual_seed(8)
    head = DecoderHead(32 + dec.position_dim, 14, generator=g).to(cuda)
    one = ph.pack_chain({"all": head}, [("all", 14)], dec.position_dim, dec.scale_offset, gelu,
                        dtype=torch.float32)
    meta = one.meta.clone()
    meta[21:26] = torch.tensor([0, 3, 7, 10, 13], dtype=torch.int32)
    one = one._replace(meta=meta, layout={"xyz": (0, 3), "rotation": (3, 4), "scale": (7, 3),
                                          "color": (10, 3), "opacity": (13, 1)})
    M = pos.shape[0]
    table = build_plane_table(planes, 3, brick_dtype=torch.int8)
    feats = sample_from_planes(dec.G.plane_axes, planes, pos[None], 1.0, 3, table=table)[0]
    staging, Mpad = ph.build_brick_staging(feats.mean(0), dec.cond0(pos), pos, 32,
                                           dtype=torch.float32)
    assert -(-Mpad // 128) < torch.cuda.get_device_properties(0).multi_processor_count
    assert Mpad % 128
    real = torch.arange(Mpad, device=cuda) < M
    for chain in (cw, one):
        assert chain.w1.shape[0] == (5 if chain is cw else 1) and chain.gelu == gelu
        rows = ph.decode_project(chain, staging, cam, M)
        again = ph.decode_project(chain, staging, cam, M)
        ref = ph.decode_project_plain(chain, staging, cam, M)
        torch.cuda.synchronize()
        assert torch.equal(rows, again)
        _hold_f32_rows(rows, ref, real, chain, cam)


@pytest.mark.parametrize("pallas_build", [True, "select"])
@pytest.mark.parametrize("brick_dtype", [torch.int8, torch.bfloat16, None])
def test_probe_table_kernel(cuda, brick_dtype, pallas_build):
    """K10 on the frozen target's probe path: the --smoke tri-grid
    generator's build_sampling_table on the card (int8 with its scales,
    bf16, f32: corner groups of 32, 64 and 128 bytes; the rotate form and
    the select form) against the plain version of the same form on the same
    card inputs: byte for byte, scales equal, one launch."""
    g = torch.Generator().manual_seed(13)
    rk = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4}
    gen = TriPlaneGenerator(z_dim=32, w_dim=32, img_resolution=32, without_sr=True,
                            channel_base=512, channel_max=32, rendering_kwargs=rk,
                            generator=g, device=cuda)
    planes = torch.randn((1, 3, 32 * gen.triplane_depth, 16, 16), generator=g).to(cuda)
    counter = (pallas_expand.brick_table_select if pallas_build == "select"
               else pallas_expand.brick_table)
    before = counter.launches
    got = gen.build_sampling_table(planes, brick_dtype=brick_dtype, pallas_build=pallas_build)
    assert counter.launches == before + 1
    vol = planes.reshape(3, 32, 3, 16, 16)
    if brick_dtype == torch.int8:
        # the card's scales are the quotient that the CPU and JAX take
        absmax = vol.abs().amax(dim=(2, 3, 4)).cpu().numpy()
        host = np.maximum(absmax / np.float32(127.0), np.float32(1e-12))
        assert np.array_equal(got[2].cpu().numpy(), host)
        vol, scales = _quantize_int8(vol)
        assert torch.equal(got[2], scales)
    elif brick_dtype is not None:
        vol = vol.to(brick_dtype)
    if pallas_build == "select":
        ref = pallas_expand.brick_table_select_plain(
            pallas_expand.duplicated_channels_last(vol), got[1], 32)
    else:
        ref = pallas_expand.brick_table_plain(pallas_expand.padded_channels_last(vol), got[1])
    torch.cuda.synchronize()
    assert len(got) == (3 if brick_dtype == torch.int8 else 2)
    assert got[1] == pallas_expand.table_rows_ny(16, vol.element_size())
    assert torch.equal(got[0].view(torch.uint8), ref.view(torch.uint8))


def test_gen_videos_frame_kernels_match_plain(cuda, tmp_path):
    """A gen_videos frame (apps/gen_videos.py, --backend pallas) at the
    --smoke widths on a decoder snapshot saved and reloaded here (the
    flagship decoder's bf16 heads with pallas_mapping; the target through
    K10's int8 probe table): K10, K1, K6's bf16 form and K3 launch once
    each, and the frame equals, at >= 50 dB (chip_smoke.py's 5g(c) limit),
    the same frame with the plain versions of K1, K6 and K3 on the same
    surface points (decoder/snapshot.py::plain_kernels, which raises if a
    kernel launched within it)."""
    import math

    from gaussian_gan_decoder_tpu_torch.apps import gen_samples, gen_videos
    from gaussian_gan_decoder_tpu_torch.decoder.snapshot import (load_decoder, plain_kernels,
                                                                 render_with_decoder,
                                                                 save_decoder)
    from gaussian_gan_decoder_tpu_torch.decoder.surface import sigma_grid_separable
    from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetSamplerConfig

    gen = gen_samples.smoke_generator(cuda)
    with torch.no_grad():
        z = torch.randn((1, 32), generator=torch.Generator().manual_seed(0)).to(cuda)
        ws = gen.mapping(z, torch.zeros((1, 25), device=cuda))
        sig = sigma_grid_separable(gen, gen.synthesis_planes(ws), shape_res=32)
    tcfg = TargetSamplerConfig(shape_res=32, num_points=20_000, neural_rendering_resolution=32,
                               mc_level=float(torch.quantile(sig.flatten(), 0.9)),
                               int8_probe=True, pallas_probe_build=True)
    dec = GaussianDecoder(gen, gelu="poly", rng=torch.Generator().manual_seed(1), device=cuda,
                          heads_bf16=True, pallas_heads=True, pallas_mapping=True)
    snap = str(tmp_path / "snap")
    save_decoder(snap, dec, gen, target_cfg=tcfg)
    dec, configs = load_decoder(snap, device=cuda)
    assert dec.pallas_mapping
    args = gen_videos.build_argparser().parse_args(
        ["--checkpoint", snap, "--backend", "pallas", "--image_size", "128"])
    counters = [(pallas_expand.brick_table, "launches"),
                (pallas_mapping.mapping_forward, "launches"),
                (pallas_heads.decode_heads, "launches_bf16"),
                (pallas_blend.blend_tiles, "launches")]
    before = [getattr(fn, a) for fn, a in counters]
    f = gen_videos.frame(dec, configs["frozen_G"], tcfg, gen_videos.seed_latents([0, 1], 32), 1,
                         args)
    torch.cuda.synchronize()
    assert [getattr(fn, a) - b for (fn, a), b in zip(counters, before)] == [1, 1, 1, 1]
    assert tuple(f.image.shape) == (3, 128, 128) and bool(torch.isfinite(f.image).all())
    assert float(f.image.std()) > 0

    def render():
        return render_with_decoder(dec, f.z, f.camera_params, f.cam2world, f.vertices,
                                   math.radians(args.fov_deg), image_size=128,
                                   backend="pallas")[0]
    kernel = render()
    with plain_kernels():
        ref = render()
    torch.cuda.synchronize()
    mse = float(((kernel - ref) ** 2).mean())
    print(f"gen_videos smoke frame, kernels vs plain versions: "
          f"{math.inf if mse == 0 else 10 * math.log10(1 / mse):.2f} dB")
    assert mse == 0 or 10 * math.log10(1 / mse) >= 50.0, mse


def test_gs3d_step_card_vs_cpu(cuda):
    """One classic 3DGS train step (train/gaussian_splatting.py: rasterize at
    SH degree 3 with the screen-space offset, L1 + SSIM, Adam) on the card
    against the same step on the CPU, from the same scene at capacity 512
    (300 points), 64^2: the loss within 1e-4 relative, Adam's first moments
    (0.1 x the gradient) within 1e-4 of each tensor's largest and the
    screen-gradient sums within 1e-4 of their largest (the same f32 sums in
    another order). The path is plain PyTorch, as JAX's is XLA: no kernel
    launches."""
    from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig
    from gaussian_gan_decoder_tpu_torch.train import gaussian_splatting as gs

    def counts():
        mods = (pallas_mapping, pallas_heads, pallas_expand, pallas_blend)
        return {(m.__name__, n, k): v for m in mods for n, f in vars(m).items()
                if callable(f) for k, v in getattr(f, "__dict__", {}).items()
                if k.startswith("launches")}

    rng = np.random.RandomState(0)
    pts = ((rng.rand(300, 3) - 0.5) * 0.6).astype(np.float32)
    cols = rng.rand(300, 3).astype(np.float32)
    gt = rng.rand(3, 64, 64).astype(np.float32)
    rest = (rng.randn(512, 15, 3) * 0.1).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.diag([-1.0, 1.0, -1.0])
    c2w[2, 3] = 2.7
    cfg = gs.GSOptimizationConfig(capacity=512, sh_degree=3)
    out = []
    before = counts()
    for dev in (torch.device("cpu"), cuda):
        state = gs.init_gs_state(pts, cols, cfg, 1.0, device=dev)
        with torch.no_grad():
            state.scene.features_rest.copy_(torch.tensor(rest))
        step = gs.make_train_step(cfg, RasterizeConfig(), 64, 1.0)
        state, m = step(state, make_camera(64, 0.5, c2w, device=dev),
                        torch.tensor(gt, device=dev), torch.zeros(3, device=dev), sh_degree=3)
        out.append((float(m["loss"]), state.grad_accum.cpu(),
                    [state.optimizer.state[getattr(state.scene, k)]["exp_avg"].cpu()
                     for k in gs.PARAMS]))
    assert counts() == before
    (lc, gc, mc), (lg, gg, mg) = out
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert float((gg - gc).abs().max()) <= 1e-4 * float(gc.abs().max()) and gc.max() > 0
    for name, a, b in zip(gs.PARAMS, mg, mc):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name


def test_gan_step_card_vs_cpu(cuda):
    """train_gan's --smoke G and D (PanoHead, mask_dual D) with the same
    weights and draws on the card and on the CPU: the G loss and the D loss
    at step 0 (density TV, camera translation and R1 on) within 1e-4
    relative, every gradient within 1e-2 of that tensor's largest CPU
    gradient (f32 sums in another order, through the renderer and R1's
    double backward); then one whole step on the card, its losses finite.
    The path is plain PyTorch, as JAX's is XLA: no kernel launches."""
    from gaussian_gan_decoder_tpu_torch.apps import train_gan
    from gaussian_gan_decoder_tpu_torch.train import gan
    from gaussian_gan_decoder_tpu_torch.utils.draws import TorchDraws

    def counts():
        mods = (pallas_mapping, pallas_heads, pallas_expand, pallas_blend)
        return {(m.__name__, n, k): v for m in mods for n, f in vars(m).items()
                if callable(f) for k, v in getattr(f, "__dict__", {}).items()
                if k.startswith("launches")}

    args = train_gan.build_argparser().parse_args(["--smoke", "--batch", "2"])
    rng = np.random.RandomState(0)
    data = {k: torch.tensor(v.astype(np.float32)) for k, v in dict(
        z=rng.randn(2, 32), c=rng.randn(2, 25) * 0.1, image=rng.rand(2, 3, 16, 16) * 2 - 1,
        image_raw=rng.rand(2, 3, 16, 16) * 2 - 1, image_mask=rng.rand(2, 1, 16, 16)).items()}
    before, out = counts(), []
    for dev in (torch.device("cpu"), cuda):
        G, D, G_ema, nrr = train_gan.build_networks(args, dev)
        cfg = train_gan.loss_config(args, nrr)
        step = gan.make_gan_train_step(G, D, cfg)
        d = {k: v.to(dev) for k, v in data.items()}
        real = {k: d[k] for k in ("image", "image_raw", "image_mask")}
        res = []
        for phase, net in (("G", G), ("D", D)):
            tensors = gan.trained_tensors(net)
            for t in tensors:
                t.requires_grad_(True)
            draws = TorchDraws(torch.Generator().manual_seed(5), dev)
            if phase == "G":
                loss, _ = step.g_loss(draws, d["z"], d["c"], 0.0, True)
            else:
                loss, _ = step.d_loss(draws, d["z"], d["c"], real, d["c"], 0.0, True)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
            res.append((float(loss.detach()), [None if g is None else g.cpu() for g in grads]))
        out.append(res)
        if dev.type == "cuda":
            state = gan.init_gan_state(G, D, G_ema, cfg)
            _, metrics = step(state, TorchDraws(torch.Generator().manual_seed(6), dev), d["z"],
                              d["c"], real, d["c"])
            assert all(np.isfinite(float(v)) for v in metrics.values())
    assert counts() == before
    for (lc, gc), (lg, gg) in zip(*out):
        assert abs(lg - lc) <= 1e-4 * abs(lc)
        for a, b in zip(gg, gc):
            assert (a is None) == (b is None)
            if b is not None and float(b.abs().max()) > 0:
                assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max())
