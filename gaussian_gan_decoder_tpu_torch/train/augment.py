"""ADA augmentation pipeline — port of train/augment.py.

The reference AugmentPipe's categories and default probability multipliers
(ref augment.py:124-565), in the JAX package's form: the geometric
augmentations (xflip, rotate90, xint, scale, rotate, aniso, xfrac) compose
one inverse affine applied by one bilinear grid sample (or, with
alias_free, the reference's wavelet-filtered warp); the colour ones
(brightness, contrast, lumaflip, hue, saturation) compose one 4x4 matrix;
then the image filter bank, additive noise and cutout; and `ada_update`,
the adaptive-p heuristic (ref training_loop.py:316-325).

Every draw goes through a draws object (utils/draws.py), one call a draw
in the JAX function's order: a test feeds JAX's draws and gets JAX's
images. Matrices are f32, as in the JAX package.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import grid_sample_2d


@dataclass(frozen=True)
class AugmentConfig:
    # probability multipliers (ref augment.py:129-151 defaults)
    xflip: float = 1.0
    rotate90: float = 1.0
    xint: float = 1.0
    xint_max: float = 0.125
    scale: float = 1.0
    rotate: float = 1.0
    aniso: float = 1.0
    xfrac: float = 1.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 1.0
    contrast: float = 1.0
    lumaflip: float = 1.0
    hue: float = 1.0
    saturation: float = 1.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    imgfilter: float = 0.0
    imgfilter_bands: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5
    alias_free: bool = False     # the reference's wavelet-filtered warp
    alias_free_margin: int = 0   # static reflect margin a side; 0: width - 1


# sym6 wavelet (ref augment.py:42): the alias-free warp's lowpass
_SYM6 = (0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
         -0.048311742585633, 0.4910559419267466, 0.787641141030194,
         0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
         0.04472490177066578, 0.0017677118642428036, -0.007800708325034148)

# sym2 wavelet (ref augment.py:38): the image filter bank's
_SYM2 = (-0.12940952255092145, 0.22414386804185735,
         0.836516303737469, 0.48296291314469025)


@functools.lru_cache(maxsize=1)
def imgfilter_bank() -> np.ndarray:
    """-> (4, taps) frequency band filters (ref Hz_fbank): band 0 the
    iterated lowpass, band i lowpass^(i-1) then highpass, dyadically
    upsampled; the rows sum to a unit impulse."""
    hz_lo = np.asarray(_SYM2)
    hz_hi = hz_lo * ((-1.0) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(fbank.shape[0], -1)[:, :-1]
        fbank = np.stack([np.convolve(row, hz_lo2) for row in fbank])
        lo = (fbank.shape[1] - hz_hi2.size) // 2
        fbank[i, lo:lo + hz_hi2.size] += hz_hi2
    return fbank.astype(np.float32)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of a reflect pad by `pad` a side, repeating the
    reflection where pad >= n (numpy's and jnp.pad's 'reflect'; F.pad
    takes pad < n only)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    m = i.remainder(2 * (n - 1))
    return torch.where(m >= n, 2 * (n - 1) - m, m)


def _reflect_pad(x: torch.Tensor, py: int, px: int) -> torch.Tensor:
    x = x.index_select(-2, _reflect_index(x.shape[-2], py, x.device))
    return x.index_select(-1, _reflect_index(x.shape[-1], px, x.device))


def apply_imgfilter(images: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Amplify the frequency bands by per-sample gains g (N, 4): a separable
    per-sample depthwise conv with reflect padding (ref augment.py:399-410)."""
    n, c, h, w = images.shape
    fbank = torch.tensor(imgfilter_bank(), device=images.device)
    hz = g @ fbank                                   # (N, taps)
    taps = fbank.shape[1]
    pd = taps // 2
    f = hz.repeat_interleave(c, dim=0)               # (N*C, taps), batch-major
    x = _reflect_pad(images.reshape(1, n * c, h, w), pd, pd)
    x = F.conv2d(x, f.reshape(n * c, 1, 1, taps), groups=n * c)
    x = F.conv2d(x, f.reshape(n * c, 1, taps, 1), groups=n * c)
    return x.reshape(n, c, h, w)


def _stack3(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot2(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _stack3([[c, -s, z], [s, c, z], [z, z, o]])


def _affine(sx, sy, tx, ty):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _stack3([[sx, z, tx], [z, sy, ty], [z, z, o]])


def _mat(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _warp_affine_alias_free(images: torch.Tensor, G_ndc: torch.Tensor,
                            margin: int = 0) -> torch.Tensor:
    """The reference's alias-free affine warp (ref augment.py:275-312):
    reflect pad -> 2x sym6 upsample -> bilinear warp at 2x -> sym6
    downsample and crop. G_ndc is the inverse transform (output -> input)
    in pixel-centre NDC; `margin` the static reflect pad a side (0: the
    reference's width - 1 clamp)."""
    from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d

    n, c, h, w = images.shape
    dev = images.device
    hz = setup_filter(list(_SYM6), device=dev)
    hz_pad = len(_SYM6) // 4
    mx = margin if margin > 0 else w - 1
    my = margin if margin > 0 else h - 1
    mx, my = min(mx, w - 1), min(my, h - 1)

    # NDC -> centred-pixel conjugation
    G = torch.einsum("ij,njk,kl->nil", _mat(np.diag([w / 2.0, h / 2.0, 1.0]), dev), G_ndc,
                     _mat(np.diag([2.0 / w, 2.0 / h, 1.0]), dev))
    x = _reflect_pad(images, my, mx)

    # upsample 2x and conjugate the transform into the upsampled frame
    x = upsample2d(x, hz, up=2)
    t_half, t_half_inv = np.eye(3), np.eye(3)
    t_half[:2, 2], t_half_inv[:2, 2] = -0.5, 0.5
    G = torch.einsum("ij,njk,kl->nil", _mat(np.diag([2.0, 2.0, 1.0]), dev), G,
                     _mat(np.diag([0.5, 0.5, 1.0]), dev))
    G = torch.einsum("ij,njk,kl->nil", _mat(t_half, dev), G, _mat(t_half_inv, dev))

    # bilinear warp at 2x into the (image + filter halo) output frame
    out_h, out_w = (h + hz_pad * 2) * 2, (w + hz_pad * 2) * 2
    in_h, in_w = x.shape[2], x.shape[3]
    Gg = torch.einsum("ij,njk,kl->nil", _mat(np.diag([2.0 / in_w, 2.0 / in_h, 1.0]), dev), G,
                      _mat(np.diag([out_w / 2.0, out_h / 2.0, 1.0]), dev))

    # torch affine_grid semantics, align_corners=False
    xs = (2.0 * torch.arange(out_w, dtype=torch.float32, device=dev) + 1.0) / out_w - 1.0
    ys = (2.0 * torch.arange(out_h, dtype=torch.float32, device=dev) + 1.0) / out_h - 1.0
    gx = (Gg[:, 0, 0, None, None] * xs[None, None, :] + Gg[:, 0, 1, None, None] * ys[None, :, None]
          + Gg[:, 0, 2, None, None])
    gy = (Gg[:, 1, 0, None, None] * xs[None, None, :] + Gg[:, 1, 1, None, None] * ys[None, :, None]
          + Gg[:, 1, 2, None, None])
    grid = torch.stack([gx.expand(n, out_h, out_w), gy.expand(n, out_h, out_w)], dim=-1)
    x = grid_sample_2d(x, grid)
    return downsample2d(x, hz, down=2, padding=-hz_pad * 2, flip_filter=True)


def augment_pipe(draws, images: torch.Tensor, p, cfg: AugmentConfig = AugmentConfig()):
    """images (N, C, H, W) in [-1, 1]; p the augment probability (a float
    or a 0-d tensor); draws: one draw a call (utils/draws.py), in the JAX
    function's order -> the augmented images."""
    n, c, h, w = images.shape
    dev = images.device
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)
    ones, zeros = torch.ones(n, device=dev), torch.zeros(n, device=dev)

    def bern(prob_mult):
        return draws.uniform((n,)) < (p * prob_mult)

    # ---- geometric: compose the inverse transforms in NDC ---------------------
    G = torch.eye(3, device=dev).expand(n, 3, 3)
    if cfg.xflip > 0:
        flip = torch.where(bern(cfg.xflip), -1.0, 1.0)
        G = G @ _affine(flip, ones, zeros, zeros)
    if cfg.rotate90 > 0:
        k90 = draws.randint((n,), 0, 4)
        theta = torch.where(bern(cfg.rotate90), k90.float() * (math.pi / 2), 0.0)
        G = G @ _rot2(theta)
    if cfg.xint > 0:
        t = (draws.uniform((n, 2)) * 2 - 1) * cfg.xint_max
        wh = torch.tensor([w, h], dtype=torch.float32, device=dev)
        t = torch.where(bern(cfg.xint)[:, None], torch.round(t * wh) / wh * 2, 0.0)
        G = G @ _affine(ones, ones, t[:, 0], t[:, 1])
    if cfg.scale > 0:
        s = torch.exp2(draws.normal((n,)) * cfg.scale_std)
        s = torch.where(bern(cfg.scale), s, 1.0)
        G = G @ _affine(s, s, zeros, zeros)
    # pre/post rotation around the anisotropic scaling, each with p_rot so
    # that P(pre or post) = rotate * p (ref :240-263)
    p_rot = 1.0 - torch.sqrt(torch.clamp(1.0 - cfg.rotate * p, 0.0, 1.0))
    if cfg.rotate > 0:
        theta = (draws.uniform((n,)) * 2 - 1) * math.pi * cfg.rotate_max
        theta = torch.where(draws.uniform((n,)) < p_rot, theta, 0.0)
        G = G @ _rot2(-theta)
    if cfg.aniso > 0:
        a = torch.exp2(draws.normal((n,)) * cfg.aniso_std)
        a = torch.where(bern(cfg.aniso), a, 1.0)
        G = G @ _affine(a, 1.0 / a, zeros, zeros)
    if cfg.rotate > 0:
        theta = (draws.uniform((n,)) * 2 - 1) * math.pi * cfg.rotate_max
        theta = torch.where(draws.uniform((n,)) < p_rot, theta, 0.0)
        G = G @ _rot2(-theta)
    if cfg.xfrac > 0:
        t = draws.normal((n, 2)) * cfg.xfrac_std
        t = torch.where(bern(cfg.xfrac)[:, None], t * 2, 0.0)
        G = G @ _affine(ones, ones, t[:, 0], t[:, 1])

    if cfg.alias_free:
        images = _warp_affine_alias_free(images, G, cfg.alias_free_margin)
    else:
        # sample the source at G @ target in pixel-centre NDC, so that the
        # identity is exact under grid_sample's align_corners=False
        ys, xs = torch.meshgrid((torch.arange(h, device=dev) + 0.5) / h * 2 - 1,
                                (torch.arange(w, device=dev) + 0.5) / w * 2 - 1, indexing="ij")
        grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)      # (H, W, 3)
        src = torch.einsum("nij,hwj->nhwi", G, grid)
        images = grid_sample_2d(images, src[..., :2] / src[..., 2:3])

    # ---- colour: compose a 4x4 matrix on homogeneous rgb ----------------------
    eye4 = torch.eye(4, device=dev)
    C = eye4.expand(n, 4, 4)
    v_axis = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev) / math.sqrt(3)
    if cfg.brightness > 0:
        b = draws.normal((n,)) * cfg.brightness_std
        b = torch.where(bern(cfg.brightness), b, 0.0)
        M = eye4.repeat(n, 1, 1)
        M[:, :3, 3] = b[:, None]
        C = M @ C
    if cfg.contrast > 0:
        s = torch.exp2(draws.normal((n,)) * cfg.contrast_std)
        s = torch.where(bern(cfg.contrast), s, 1.0)
        C = torch.diag_embed(torch.stack([s, s, s, ones], -1)) @ C
    if cfg.lumaflip > 0:
        do = bern(cfg.lumaflip).float()
        house = eye4 - 2 * torch.outer(v_axis, v_axis)
        M = eye4[None] * (1 - do)[:, None, None] + house[None] * do[:, None, None]
        C = M @ C
    if cfg.hue > 0:
        theta = (draws.uniform((n,)) * 2 - 1) * math.pi * cfg.hue_max
        theta = torch.where(bern(cfg.hue), theta, 0.0)
        k = v_axis[:3]
        zero = torch.zeros((), device=dev)
        K = torch.stack([torch.stack([zero, -k[2], k[1]]), torch.stack([k[2], zero, -k[0]]),
                         torch.stack([-k[1], k[0], zero])])
        R = (torch.eye(3, device=dev) + torch.sin(theta)[:, None, None] * K
             + (1 - torch.cos(theta))[:, None, None] * (K @ K))
        M = eye4.repeat(n, 1, 1)
        M[:, :3, :3] = R
        C = M @ C
    if cfg.saturation > 0:
        s = torch.exp2(draws.normal((n,)) * cfg.saturation_std)
        s = torch.where(bern(cfg.saturation), s, 1.0)
        outer = torch.outer(v_axis, v_axis)
        C = (outer + (eye4 - outer) * s[:, None, None]) @ C

    rgb = torch.cat([images[:, :3], torch.ones((n, 1, h, w), dtype=images.dtype, device=dev)],
                    dim=1)
    rgb = torch.einsum("nij,njhw->nihw", C.to(images.dtype), rgb)[:, :3]
    images = torch.cat([rgb, images[:, 3:]], dim=1) if c > 3 else rgb

    # ---- image-space filtering (ref augment.py:382-410) -----------------------
    if cfg.imgfilter > 0:
        num_bands = 4
        assert len(cfg.imgfilter_bands) == num_bands
        expected_power = torch.tensor([10.0, 1.0, 1.0, 1.0], device=dev) / 13.0
        g = torch.ones((n, num_bands), device=dev)
        for i, band_strength in enumerate(cfg.imgfilter_bands):
            t_i = torch.exp2(draws.normal((n,)) * cfg.imgfilter_std)
            t_i = torch.where(bern(cfg.imgfilter * band_strength), t_i, 1.0)
            t = torch.ones((n, num_bands), device=dev)
            t[:, i] = t_i
            t = t / torch.sqrt((expected_power * t.square()).sum(-1, keepdim=True))
            g = g * t
        images = apply_imgfilter(images, g.to(images.dtype))

    # ---- corruption -------------------------------------------------------------
    if cfg.noise > 0:
        sigma = draws.normal((n,)).abs() * cfg.noise_std
        sigma = torch.where(bern(cfg.noise), sigma, 0.0)
        images = images + draws.normal(images.shape).to(images.dtype) * sigma[:, None, None, None]
    if cfg.cutout > 0:
        center = draws.uniform((n, 2))
        do = bern(cfg.cutout)
        ys_n = (torch.arange(h, device=dev) + 0.5) / h
        xs_n = (torch.arange(w, device=dev) + 0.5) / w
        inside_y = (ys_n[None, :] - center[:, 1:2]).abs() < cfg.cutout_size / 2
        inside_x = (xs_n[None, :] - center[:, 0:1]).abs() < cfg.cutout_size / 2
        mask = inside_y[:, :, None] & inside_x[:, None, :] & do[:, None, None]
        images = torch.where(mask[:, None], 0.0, images)
    return images


def ada_update(p, real_logit_signs_mean, batch_size, ada_interval: int = 4,
               ada_target: float = 0.6, ada_kimg: float = 500.0) -> np.float32:
    """The adaptive-p heuristic (ref training_loop.py:316-325), in float32
    as the JAX package computes it."""
    f32 = np.float32
    adjust = (np.sign(f32(real_logit_signs_mean) - f32(ada_target))
              * f32(batch_size * ada_interval / (ada_kimg * 1000.0)))
    return f32(np.clip(f32(p) + f32(adjust), f32(0.0), f32(1.0)))
