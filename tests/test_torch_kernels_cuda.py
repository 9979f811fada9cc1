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

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("batch,c_dim", [(1, 25), (3, 25), (2, 0)])
def test_mapping_kernel(cuda, batch, c_dim):
    g = torch.Generator().manual_seed(batch)
    mn = MappingNetwork(64, c_dim, 96, num_ws=5, generator=g)
    with torch.no_grad():
        mn.w_avg.normal_(generator=g)
    fm = pallas_mapping.fold_mapping(mn.to(cuda))
    z = torch.randn(batch, 64, generator=g).to(cuda)
    c = torch.randn(batch, c_dim, generator=g).to(cuda) if c_dim else None
    out = pallas_mapping.mapping_forward(z, c, fm, 0.7)[:, 0]
    ref = pallas_mapping.mapping_forward_plain(z, c, fm, 0.7)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-3


def _small_frame(cuda):
    g = torch.Generator().manual_seed(0)
    gen = TriPlaneGenerator(z_dim=32, c_dim=25, w_dim=32, img_resolution=64,
                            channel_base=512, channel_max=32,
                            rendering_kwargs={"triplane_size": 32}, generator=g)
    dec = GaussianDecoder(gen, rng=g).to(cuda)
    pos = ((np.random.RandomState(1).rand(3000, 3) - 0.5) * 0.4).astype(np.float32)
    ctx = dec.make_slab_context(pos, block=256, device=cuda)
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


def test_slab_decode_kernel(cuda):
    w, ctx, cam, vol, scales = _small_frame(cuda)
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
    out = pallas_blend.blend_train(starts, attrs, 4, 4, 16, max_k)
    acc_p, tr_p = pallas_blend.blend_train_plain(starts, attrs, 4, 4, 16, max_k)
    torch.cuda.synchronize()
    assert float((out[..., :3] - acc_p).abs().max()) <= 1e-5
    assert float((out[..., 3] - tr_p).abs().max()) <= 1e-5
    g = torch.Generator(device="cpu").manual_seed(1)
    dout = torch.randn(out.shape, generator=g).to(cuda)
    d_k = pallas_blend.blend_train_bwd(starts, attrs, out, dout, 4, 4, 16, max_k)
    d_p = pallas_blend.blend_train_bwd_plain(starts, attrs, acc_p, tr_p, dout[..., :3],
                                             dout[..., 3], 4, 4, 16, max_k)
    torch.cuda.synchronize()
    err = (d_k - d_p).abs().amax(dim=1) / d_p.abs().amax(dim=1).clamp(min=1e-12)
    assert float(err.max()) <= 1e-3, err.tolist()
    assert bool(torch.isfinite(d_k).all())


def test_heads_train_kernels(cuda):
    """K6 and K7 against decode_heads_plain / decode_heads_bwd_plain on the
    exact-GELU sequential_reversed chain: outputs within 1e-5 and gradients
    within 1e-4 of their max (f32, summation order only)."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads_vjp
    from gaussian_gan_decoder_tpu_torch.decoder.heads import CHAIN, DecoderHead

    g = torch.Generator().manual_seed(0)
    heads, cond = {}, 3
    for name, od in CHAIN:
        heads[name] = DecoderHead(32 + cond, od, generator=g).to(cuda)
        cond += od
    M = 16384 + 64   # K7: more 32-point tiles than blocks
    feats = (torch.randn(M, 32, generator=g) * 2).to(cuda)
    pos = (torch.rand(M, 3, generator=g) - 0.5).to(cuda)
    with torch.no_grad():
        cw = pallas_heads.pack_chain_f32(heads, CHAIN, 3, -2.5, "exact")
        st = pallas_heads.build_staging_f32(feats, pos, pos)
        out = pallas_heads.decode_heads(st, cw)
        ref = pallas_heads.decode_heads_plain(st, cw)
        dout = torch.randn(M, 16, generator=g).to(cuda)
        dst, grads = pallas_heads_vjp.decode_heads_bwd(st, out, dout, cw)
        dst_p, grads_p = pallas_heads_vjp.decode_heads_bwd_plain(st, ref, dout, cw)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert float((dst - dst_p).abs().max() / dst_p.abs().max()) <= 1e-4
    for a, b in zip(grads, grads_p):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
