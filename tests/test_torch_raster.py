"""Port parity of the frame's rasterizer: GPU-style binning + the tile
blend's plain version (kernel K3's CPU path) of
gaussian_gan_decoder_tpu_torch vs the JAX fast rasterizer with an f32
payload (Pallas blend in interpret mode), on the same decode rows — the
JAX slab decoder's output for a seeded ~1000-point template."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.decoder.pallas_heads import PROJ_ROWS as JPROJ_ROWS
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.flagship import flagship_raster_config as jraster_config
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.splat.fast_raster import bin_pairs_lexsort_ch
from gaussian_gan_decoder_tpu.splat.fast_raster import render_rows as jrender_rows
from gaussian_gan_decoder_tpu_torch.flagship import flagship_raster_config
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.splat.fast_raster import bin_pairs, render_rows
from gaussian_gan_decoder_tpu_torch.splat.pallas_blend import blend_tiles
from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig
from _torch_threads import torch_threads  # noqa: F401  (autouse)

TS, M, BLOCK, IMG, FOV = 32, 1000, 256, 64, 0.227
BG = (0.0, 0.0, 0.0)   # black: the image is the Gaussians alone


def f32_config():
    """The JAX fast path with the payload the port carries: 9 f32 fields,
    the full 32-bit depth key, no pair dropped."""
    return dataclasses.replace(jraster_config(), packed_payloads=False, bf16_colors=False,
                               fused_sort_key=False, rgb10_payloads=False,
                               static_copies=4, overflow_budget=8192)


def head_params(jd, seed):
    """The JAX decoder's head parameters (torch.nn.Linear init), drawn with
    numpy: cheaper than tracing the JAX init."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, head in jd._heads().items():
        params[name] = {}
        for i, (din, dout) in enumerate(head._dims()):
            b = 1.0 / np.sqrt(din)
            params[name][f"fc{i}"] = {
                "weight": jnp.asarray(rng.uniform(-b, b, (dout, din)).astype(np.float32)),
                "bias": jnp.asarray(rng.uniform(-b, b, (dout,)).astype(np.float32))}
    return params


@pytest.fixture(scope="module")
def frame():
    jg = JGen(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, channel_base=512,
              channel_max=32, without_sr=True, rendering_kwargs=(("triplane_size", TS),))
    jd = JDec(generator=jg, decoder_type="sequential_reversed", int8_sampling=True,
              pallas_heads=True, heads_bf16=True, gelu="poly6", slab_sampling=True)
    params = head_params(jd, 3)
    rng = np.random.RandomState(9)
    planes = jnp.asarray(rng.randn(1, 3, 96, TS, TS).astype(np.float32))
    pos = ((rng.rand(M, 3) - 0.5) * 0.4).astype(np.float32)
    _, c2w = jcam_params()
    jcam = jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), c2w)
    ctx = jd.make_slab_context(pos, block=BLOCK)
    rows, _ = jd.decode_project(params, planes, jnp.asarray(pos), jcam, slab_ctx=ctx)
    out = jrender_rows(jcam, rows, None, M, bg=jnp.asarray(BG, jnp.float32),
                       config=f32_config())
    r = {k: rows[v] for k, v in JPROJ_ROWS.items()}
    ch = dict(px=r["px"], py=r["py"], depth=r["depth"], radius_f=r["radius_f"],
              visible=r["visible"] > 0.5)
    fields = [r[k] for k in ("px", "py", "conic_a", "conic_b", "conic_c", "opac",
                             "col_r", "col_g", "col_b")]
    starts, attrs, _ = bin_pairs_lexsort_ch(ch, fields, IMG // 16, IMG // 16, 16,
                                            static_copies=4, overflow_budget=8192)
    return dict(rows=np.asarray(rows), c2w=np.asarray(c2w), img=np.asarray(out["render"]),
                n_dropped=int(out["n_dropped"]), starts=np.asarray(starts),
                attrs=np.asarray(attrs))


def test_binning_matches_jax(frame):
    """Same tile_starts and, per tile, the same pairs in the same depth
    order (the JAX binning drops nothing here)."""
    assert frame["n_dropped"] == 0
    starts, attrs = bin_pairs(torch.tensor(frame["rows"]), IMG // 16, IMG // 16, 16)
    np.testing.assert_array_equal(starts.numpy(), frame["starts"])
    n = int(starts[-1])
    assert n > 0 and attrs.shape == (9, n)
    np.testing.assert_array_equal(attrs.numpy(), frame["attrs"][:9, :n])


def test_render_rows_matches_jax(frame):
    """f32 payloads on both sides (the flagship's packed_v3 frame is held in
    test_torch_raster_payloads.py)."""
    cam = make_camera(IMG, FOV, frame["c2w"])
    before = blend_tiles.launches
    cfg = RasterizeConfig(tile_capacity=flagship_raster_config().tile_capacity)
    out = render_rows(cam, torch.tensor(frame["rows"]), torch.tensor(BG), cfg)
    assert blend_tiles.launches == before
    img = out["render"].numpy()
    ref = frame["img"]
    assert img.shape == ref.shape == (3, IMG, IMG) and ref.max() > 0.1
    psnr = 10 * np.log10(1.0 / np.mean((img - ref) ** 2))
    print(f"port render_rows vs JAX f32-payload render_rows: {psnr:.1f} dB")
    assert psnr >= 60.0, psnr
    assert out["n_dropped"] == 0
    assert out["n_pairs"] == int(frame["starts"][-1]) > 0


def test_blend_truncates_at_tile_capacity(frame):
    """max_k caps each tile's pair stream like the TPU kernel: a tile cut
    to its first k pairs blends exactly those k pairs."""
    starts, attrs = bin_pairs(torch.tensor(frame["rows"]), IMG // 16, IMG // 16, 16)
    counts = (starts[1:] - starts[:-1]).numpy()
    t = int(np.argmax(counts))
    k = int(counts[t]) // 2
    acc_k, tr_k = blend_tiles(starts, attrs, IMG // 16, IMG // 16, 16, max_k=k)
    cut = torch.cat([attrs[:, :int(starts[t]) + k],
                     attrs[:, int(starts[t + 1]):]], dim=1)
    starts_cut = starts.clone()
    starts_cut[t + 1:] -= int(counts[t]) - k
    acc_c, tr_c = blend_tiles(starts_cut, cut, IMG // 16, IMG // 16, 16, max_k=10 ** 6)
    np.testing.assert_allclose(acc_k[t].numpy(), acc_c[t].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tr_k[t].numpy(), tr_c[t].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cap", [1024, 64])
def test_training_binning_keeps_each_tiles_budget(cap):
    """rasterize_fast bins only each tile's first tile_capacity pairs (the
    ones the blend reads): against binning every pair, the training blend's
    image is bit-identical and every gradient within 1e-6 of its largest
    (the gather's backward sums in another order); 3000 Gaussians at 64^2,
    some tiles past 1024 pairs."""
    from gaussian_gan_decoder_tpu_torch.splat import fast_raster
    from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig, render_simple
    rng = np.random.RandomState(3)
    n = 3000
    decoded = {k: torch.tensor(v.astype(np.float32), requires_grad=True) for k, v in (
        ("xyz", (rng.rand(n, 3) - 0.5) * 0.4), ("scale", rng.randn(n, 3) * 0.3 - 4.5),
        ("rotation", rng.randn(n, 4)), ("opacity", rng.randn(n, 1)), ("color", rng.randn(n, 3)))}
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.diag([-1.0, 1.0, -1.0])
    c2w[2, 3] = 2.7
    cam, bg, cfg = make_camera(64, FOV, c2w), torch.tensor([0.2, 0.3, 0.4]), RasterizeConfig(
        tile_capacity=cap)
    runs = []
    for truncate in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not truncate:
                real = fast_raster.bin_indices
                mp.setattr(fast_raster, "bin_indices", lambda *a: real(*a[:8]))
            out = render_simple(cam, decoded, bg, cfg)
        out["render"].square().sum().backward()
        runs.append((out, {k: v.grad.clone() for k, v in decoded.items()}))
        for v in decoded.values():
            v.grad = None
    (cut, gcut), (full, gfull) = runs
    assert cut["n_pairs"] < full["n_pairs"] and torch.equal(cut["render"], full["render"])
    for k, g in gfull.items():
        assert float((gcut[k] - g).abs().max()) <= 1e-6 * float(g.abs().max()), k
