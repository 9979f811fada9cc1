"""Port parity of the frame rasterizer's payload formats and fused sort key
(the JAX flagship frame's settings) against the JAX package: the packers
bit for bit, the fused-key binning's sorted keys and per-tile pair order
exactly, the plain K3 forms (f32, bf16_colors, packed_v2, packed_v3, and
the packed forms with mxu_power) against JAX pallas_blend in interpret mode
on the same sorted words, render_rows with flagship_raster_config() frame
for frame, and the flagship raster fields. The decode rows are synthetic:
1,500 Gaussians at 64^2 with exact and 2^-12-close depth ties, giant flat
Gaussians (conic ~1e-6, spilling into JAX's overflow lane) and negative
conic_b."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.flagship import flagship_raster_config as jraster_config
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.splat import fast_raster as jfr
from gaussian_gan_decoder_tpu.splat import pallas_blend as jpb
from gaussian_gan_decoder_tpu_torch.decoder.pallas_heads import NROWS, PROJ_ROWS
from gaussian_gan_decoder_tpu_torch.flagship import flagship_raster_config
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.splat import fast_raster, pallas_blend
from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig
from _torch_threads import torch_threads  # noqa: F401  (autouse)

M, IMG, FOV, CAP = 1500, 64, 0.227, 640
G = IMG // 16
BG = (0.1, 0.2, 0.3)
FIELDS = ("px", "py", "conic_a", "conic_b", "conic_c", "opac", "col_r", "col_g", "col_b")
# payload format -> the JAX bin_pairs_lexsort_ch flags
JAX_FLAGS = {
    "f32": dict(),
    "bf16_colors": dict(bf16_colors=True),
    "packed_v2": dict(packed_payloads=True, fused_sort_key=True),
    "packed_v3": dict(packed_payloads=True, fused_sort_key=True, rgb10=True),
}


def synthetic_rows(seed=0):
    """(NROWS, M) decode rows: screen-space Gaussians with covariances of
    0.3-30 px^2 (and 12 giants of up to 1e6 px^2), depths from 5 exact
    values, half of them nudged by less than the fused key's 2^-12."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((NROWS, M), np.float32)
    ev = np.exp(rng.uniform(np.log(0.3), np.log(30.0), (M, 2)))
    ev[:12] = np.exp(rng.uniform(np.log(1e3), np.log(1e6), (12, 2)))
    th = rng.uniform(0, np.pi, M)
    c, s = np.cos(th), np.sin(th)
    a = ev[:, 0] * c * c + ev[:, 1] * s * s
    b = (ev[:, 0] - ev[:, 1]) * c * s
    d = ev[:, 0] * s * s + ev[:, 1] * c * c
    det = a * d - b * b
    r = {"px": rng.uniform(-8, IMG + 8, M), "py": rng.uniform(-8, IMG + 8, M),
         "conic_a": d / det, "conic_b": -b / det, "conic_c": a / det,
         "opac": rng.uniform(0.02, 1.0, M),
         "col_r": rng.uniform(0, 1.6, M), "col_g": rng.uniform(0, 1.6, M),
         "col_b": rng.uniform(0, 1.6, M),
         "depth": (1.0 + 0.25 * rng.randint(0, 5, M)) * (1 + rng.randint(0, 2, M) * 1e-5),
         "radius_f": np.ceil(3 * np.sqrt(ev.max(1))),
         "visible": (rng.rand(M) < 0.97).astype(np.float32)}
    for k, v in r.items():
        rows[PROJ_ROWS[k]] = v
    return rows


def jax_bin(rows, fmt, copies=2):
    r = {k: jnp.asarray(rows[v]) for k, v in PROJ_ROWS.items()}
    ch = dict(px=r["px"], py=r["py"], depth=r["depth"], radius_f=r["radius_f"],
              visible=r["visible"] > 0.5)
    starts, attrs, dropped = jfr.bin_pairs_lexsort_ch(
        ch, [r[k] for k in FIELDS], G, G, 16, static_copies=copies, overflow_budget=8192,
        **JAX_FLAGS[fmt])
    assert int(dropped) == 0
    return np.asarray(starts), np.asarray(attrs)


@pytest.fixture(scope="module")
def rows():
    return synthetic_rows()


def test_packers_match_jax_bit_for_bit():
    """bf16 / int16 / f16 / rgb10 packing and the blend's unpacking on random
    and edge values: rounding ties, clamps, giant flat conics, negative
    conic_b, the f16 subnormal flush and the 0x7BFF clamp."""
    rng = np.random.RandomState(1)
    edge = np.array([0.0, -0.0, 1e-9, -1e-9, 6e-9, 1.5e-8, 3.05e-8, 1e-6, -1e-6, 0.5, -0.5,
                     1 / 64, 3 / 64, -3 / 64, 15.999, 16.0, 17.0, -20.0, 1e5, -1e5, 1023.99,
                     1024.5, 2.0 ** -24, 65504.0 / 4096, 4.0, 3.998, 1 / 512, 3 / 512],
                    np.float32)
    rand = np.concatenate([rng.randn(3000) * 10.0 ** rng.uniform(-7, 3, 3000),
                           rng.uniform(-40, 40, 1000)]).astype(np.float32)
    x = np.concatenate([edge, rand])
    y = np.roll(x, 7)
    tx, ty = torch.tensor(x), torch.tensor(y)
    bits = lambda v: np.asarray(v).view(np.int32)   # noqa: E731
    cases = [(fast_raster.bf16_pack_pair(tx, ty), jfr._bf16_pack_pair(x, y)),
             (fast_raster.i16_pack_pair(tx, ty), jfr._i16_pack_pair(x, y)),
             (fast_raster.f16_pack_pair(tx, ty), jfr._f16_pack_pair(x, y)),
             (fast_raster.rgb10_pack(tx, ty, tx.abs()), jfr._rgb10_pack(x, y, np.abs(x)))]
    for mine, ref in cases:
        np.testing.assert_array_equal(bits(mine.numpy()), bits(ref))
    u = torch.tensor(rng.randint(0, 65536, 5000).astype(np.int32))
    np.testing.assert_array_equal(bits(pallas_blend.f16_unpack(u).numpy()),
                                  bits(jpb._f16_unpack(jnp.asarray(u.numpy()), 12)))
    # the flush and the clamp are reached
    half = fast_raster._half_bits(tx, fast_raster.CONIC_SCALE).numpy()
    assert (half[np.abs(x) * 4096 < 6.1e-5] & 0x7FFF == 0).all()
    assert (half & 0x7FFF == 0x7BFF).sum() >= 4


def test_fused_key_binning_matches_jax(rows):
    """The fused-key binning of packed_v3 (flagship settings): the sorted
    fused keys, tile_starts and every pair's words equal JAX's
    bin_pairs_lexsort_ch (static copies 2, the overflow lane) exactly, with
    frequent key ties in both copy classes' order."""
    cfg = flagship_raster_config()
    starts, attrs = fast_raster.bin_pairs(torch.tensor(rows), G, G, 16, cfg)
    jstarts, jattrs = jax_bin(rows, "packed_v3", cfg.static_copies)
    n = int(starts[-1])
    np.testing.assert_array_equal(starts.numpy(), jstarts)
    assert attrs.shape == (4, n)
    np.testing.assert_array_equal(attrs.numpy().view(np.int32), jattrs[:4, :n].view(np.int32))
    # the sorted keys: JAX's fused keys of its sorted pairs, the port's from
    # its (pair, tile)
    r = {k: torch.tensor(rows[v]) for k, v in PROJ_ROWS.items()}
    _, pair, tile = fast_raster.bin_indices(r["px"], r["py"], r["radius_f"], r["depth"],
                                            r["visible"] > 0.5, G, G, 16, fused_key=True,
                                            copies=cfg.static_copies)
    qd = r["depth"].clamp(min=1e-6).view(torch.int32).long()[pair]
    key = ((tile << 21) | (qd >> 11)).numpy()
    jr = {k: jnp.asarray(v) for k, v in r.items()}
    ch = dict(px=jr["px"], py=jr["py"], depth=jr["depth"], radius_f=jr["radius_f"],
              visible=jr["visible"] > 0.5)
    tk, jqd, fields, _ = jfr.build_pairs_packed(ch, [jr[k] for k in FIELDS], G, G, 16,
                                                cfg.static_copies, 8192, rgb10=True)
    fkey = (tk.astype(jnp.uint32) << 21) | (jqd.astype(jnp.uint32) >> 11)
    jkey = np.asarray(jax.lax.sort([fkey] + fields, num_keys=1)[0])[:n]
    np.testing.assert_array_equal(key, jkey.astype(np.int64))
    ties = key[1:] == key[:-1]
    print(f"{n} pairs, {int(ties.sum())} adjacent fused-key ties")
    assert ties.sum() > 100


def test_plain_blend_forms_match_jax(rows):
    """K3's plain version in each payload form (f32, bf16_colors, packed_v2,
    packed_v3, the packed two with mxu_power) against JAX pallas_blend
    (interpret mode) on JAX's own sorted words: accumulated rgb and the
    final transmittance within 2e-5 (the blends sum in other orders)."""
    for fmt, mxu in (("f32", False), ("bf16_colors", False), ("packed_v2", False),
                     ("packed_v3", False), ("packed_v2", True), ("packed_v3", True)):
        jstarts, jattrs = jax_bin(rows, fmt)
        n_rows = pallas_blend.PAYLOAD_ROWS[fmt]
        n = int(jstarts[-1])
        padded = np.concatenate(
            [jattrs, np.zeros((jattrs.shape[0], CAP + jpb.CHUNK), np.float32)], axis=1)
        jacc, jtr = jpb.pallas_blend(jnp.asarray(jstarts), jnp.asarray(padded), G, G, 16,
                                     max_k=CAP, interpret=True, payload_format=fmt,
                                     mxu_power=mxu)
        acc, tr = pallas_blend.blend_tiles(
            torch.tensor(jstarts), torch.tensor(np.ascontiguousarray(jattrs[:n_rows, :n])),
            G, G, 16, CAP, payload_format=fmt, mxu_power=mxu)
        err = max(np.abs(acc.numpy() - np.asarray(jacc)).max(),
                  np.abs(tr.numpy() - np.asarray(jtr)).max())
        print(f"{fmt} mxu={mxu}: {n} pairs, max |d| {err:.3e}, T min {float(tr.min()):.3e}")
        assert float(tr.min()) < 0.5 and err <= 2e-5, (fmt, mxu, err)


def test_render_rows_flagship_matches_jax(rows):
    """render_rows with the flagship raster config (packed_v3, fused key,
    static copies 2) against the JAX flagship frame's render_rows (its own
    config, interpret mode; no pair dropped), PSNR >= 80 dB; the same pair
    count; unsupported combinations raise."""
    _, c2w = jcam_params()
    jcam = jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), c2w)
    jout = jfr.render_rows(jcam, jnp.asarray(rows), None, M, bg=jnp.asarray(BG, jnp.float32),
                           config=jraster_config())
    assert int(jout["n_dropped"]) == 0
    cam = make_camera(IMG, FOV, np.asarray(c2w))
    out = fast_raster.render_rows(cam, torch.tensor(rows), torch.tensor(BG),
                                  flagship_raster_config())
    img, ref = out["render"].numpy(), np.asarray(jout["render"])
    psnr = 10 * np.log10(1.0 / max(np.mean((img - ref) ** 2), 1e-20))
    print(f"port flagship render_rows vs JAX's: {psnr:.1f} dB")
    assert psnr >= 80.0, psnr
    assert out["n_pairs"] == int(jax_bin(rows, "packed_v3")[0][-1])
    with pytest.raises(ValueError):
        pallas_blend.blend_tiles(*fast_raster.bin_pairs(torch.tensor(rows), G, G, 16), G, G,
                                 mxu_power=True)
    with pytest.raises(ValueError):
        fast_raster.bin_pairs(torch.tensor(rows), 64, 64, 16, flagship_raster_config())


def test_flagship_raster_fields_match_jax():
    """The port's flagship raster settings are the JAX flagship's, field by
    field, and pick the JAX payload format, key and falloff."""
    mine, ref = flagship_raster_config(), jraster_config()
    for f in dataclasses.fields(RasterizeConfig):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert (mine.payload_format, mine.fused_key, mine.mxu_power) == ("packed_v3", True, False)
    assert RasterizeConfig(bf16_colors=True).payload_format == "bf16_colors"
    assert RasterizeConfig(packed_payloads=True, bf16_colors=True).payload_format == "packed_v2"
    assert not RasterizeConfig(fused_sort_key=True, blend_mxu_power=True).fused_key
    assert not RasterizeConfig(blend_mxu_power=True).mxu_power
