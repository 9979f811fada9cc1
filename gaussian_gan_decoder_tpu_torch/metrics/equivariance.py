"""Equivariance metrics (EQ-T, EQ-T_frac, EQ-R) of "Alias-Free GANs" —
port of metrics/equivariance.py (the reference's eg3d/metrics/
equivariance.py:23-266).

The image operators (integer and fractional translation, the oriented
band-limit filter, affine resampling) are the JAX package's in the same
order of arithmetic, on the port's ops (ops/upfirdn2d.py filter2d and
upsample2d, ops/grid_sample.py). Each batch synthesises the identity pass
and the transformed pass by handing the generator's synthesis the 3x3
user transform (models/stylegan3.py), as the JAX package traces it; the
translations and angles are drawn on the host by numpy's default_rng
seeded with the key's last word, z by JAX's key stream (utils/
jax_random.py), so a key gives the JAX package's draws. Requires a
generator whose synthesis input takes a user transform (Generator3), and
raises otherwise, as the reference (:202-204).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import filter2d, grid_sample_2d, upsample2d
from ..utils import jax_random


def sinc(x):
    y = (x * np.pi).abs()
    z = torch.sin(y) / y.clamp(min=1e-30)
    return torch.where(y < 1e-30, torch.ones_like(z), z)


def lanczos_window(x, a):
    x = x.abs() / a
    return torch.where(x < 1, sinc(x), torch.zeros_like(x))


def rotation_matrix(angle: float) -> np.ndarray:
    a = float(angle)
    m = np.eye(3, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = np.cos(a), np.sin(a), -np.sin(a), np.cos(a)
    return m


def apply_integer_translation(x, tx, ty):
    """T_x, integer (ref :46-62): tx, ty host floats in units of the image size."""
    _, _, H, W = x.shape
    ix, iy = int(round(float(tx) * W)), int(round(float(ty) * H))
    z, m = torch.zeros_like(x), torch.zeros_like(x)
    if abs(ix) < W and abs(iy) < H:
        y = x[:, :, max(-iy, 0):H + min(-iy, 0), max(-ix, 0):W + min(-ix, 0)]
        z[:, :, max(iy, 0):H + min(iy, 0), max(ix, 0):W + min(ix, 0)] = y
        m[:, :, max(iy, 0):H + min(iy, 0), max(ix, 0):W + min(ix, 0)] = 1.0
    return z, m


def _lanczos_shift_taps(frac: float, a: int, device) -> torch.Tensor:
    """2a normalised Lanczos-a taps shifting by frac in [0, 1)."""
    grid = torch.arange(2 * a, dtype=torch.float32, device=device) - (a - 1) - frac
    taps = sinc(grid) * sinc(grid / a)
    return taps / taps.sum()


def apply_fractional_translation(x, tx, ty, a: int = 3):
    """T_x, fractional: separable windowed-sinc resampling (ref :67-97)."""
    _, _, H, W = x.shape
    shift_x, shift_y = float(tx) * W, float(ty) * H
    wx, wy = int(math.floor(shift_x)), int(math.floor(shift_y))
    halo = a - 1
    out = torch.zeros_like(x)
    dst_l, dst_t = max(wx - halo, 0), max(wy - halo, 0)
    dst_r, dst_b = min(wx + a, 0) + W, min(wy + a, 0) + H
    if dst_l < dst_r and dst_t < dst_b:
        fx = _lanczos_shift_taps(shift_x - wx, a, x.device)
        fy = _lanczos_shift_taps(shift_y - wy, a, x.device)
        y = filter2d(x, fx[None, :], padding=[halo, a, 0, 0])
        y = filter2d(y, fy[:, None], padding=[0, 0, halo, a])
        y = y[:, :, max(halo - wy, 0):H + halo + a + min(-wy - a, 0),
              max(halo - wx, 0):W + halo + a + min(-wx - a, 0)]
        out[:, :, dst_t:dst_b, dst_l:dst_r] = y
    valid = torch.zeros_like(x)
    v_l, v_t = max(wx + a, 0), max(wy + a, 0)
    v_r, v_b = min(wx - halo, 0) + W, min(wy - halo, 0) + H
    if v_l < v_r and v_t < v_b:
        valid[:, :, v_t:v_b, v_l:v_r] = 1.0
    return out, valid


def _conv2_circular(p, q):
    return torch.real(torch.fft.ifftn(torch.fft.fftn(p) * torch.fft.fftn(q)))


def construct_affine_bandlimit_filter(mat, a=3, amax=16, aflt=64, up=4, cutoff_in=1.0,
                                      cutoff_out=1.0, device=None):
    """The oriented band-limit filter of an affine transform (ref :103-132)."""
    assert a <= amax < aflt
    mat = torch.as_tensor(np.asarray(mat, np.float32), device=device)
    coords = torch.roll((torch.arange(aflt * up * 2 - 1, dtype=torch.float32, device=device)
                         + 1) / up - aflt, 1 - aflt * up)
    src_y, src_x = torch.meshgrid(coords, coords, indexing="ij")
    mapped = torch.stack([src_x, src_y], dim=2) @ mat[:2, :2].T
    dst_x, dst_y = mapped[..., 0], mapped[..., 1]
    band = _conv2_circular(sinc(src_x * cutoff_in) * sinc(src_y * cutoff_in),
                           sinc(dst_x * cutoff_out) * sinc(dst_y * cutoff_out))
    window = _conv2_circular(lanczos_window(src_x, a) * lanczos_window(src_y, a),
                             lanczos_window(dst_x, a) * lanczos_window(dst_y, a))
    f = band * window
    crop = (aflt - amax) * up
    f = torch.roll(f, (aflt * up - 1, aflt * up - 1), dims=(0, 1))[crop:-crop, crop:-crop]
    f = torch.nn.functional.pad(f, (0, 1, 0, 1)).reshape(amax * 2, up, amax * 2, up)
    f = f / f.sum(dim=(0, 2), keepdim=True) / (up ** 2)
    return f.reshape(amax * 2 * up, amax * 2 * up)[:-1, :-1]


def _affine_grid(theta, N, H, W):
    """affine_grid, align_corners=False: (2, 3) theta -> (N, H, W, 2)."""
    xs = (2.0 * torch.arange(W, dtype=torch.float32, device=theta.device) + 1.0) / W - 1.0
    ys = (2.0 * torch.arange(H, dtype=torch.float32, device=theta.device) + 1.0) / H - 1.0
    gx, gy = xs[None, :], ys[:, None]
    out_x = theta[0, 0] * gx + theta[0, 1] * gy + theta[0, 2]
    out_y = theta[1, 0] * gx + theta[1, 1] * gy + theta[1, 2]
    g = torch.stack([out_x.expand(H, W), out_y.expand(H, W)], dim=-1)
    return g[None].expand(N, H, W, 2)


def _grid_sample_nearest(x, grid):
    """zeros-padded nearest-neighbour grid_sample (align_corners=False);
    ties round to even, as jnp.round."""
    N, C, H, W = x.shape
    ix = torch.round(((grid[..., 0] + 1.0) * W - 1.0) * 0.5).long()
    iy = torch.round(((grid[..., 1] + 1.0) * H - 1.0) * 0.5).long()
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)       # (N, Ho, Wo)
    flat = x.permute(0, 2, 3, 1).reshape(N, H * W, C)
    out = torch.gather(flat, 1, idx.reshape(N, -1, 1).expand(-1, -1, C))
    out = out.reshape(*idx.shape, C) * valid[..., None].to(out.dtype)
    return out.permute(0, 3, 1, 2)


def apply_affine_transformation(x, mat, up=4, **filter_kwargs):
    """Upsample -> affine grid -> bilinear (ref :137-166)."""
    N, _, H, W = x.shape
    f = construct_affine_bandlimit_filter(mat, up=up, device=x.device, **filter_kwargs)
    assert f.ndim == 2 and f.shape[0] == f.shape[1] and f.shape[0] % 2 == 1
    p = f.shape[0] // 2
    theta = torch.linalg.inv(torch.as_tensor(np.asarray(mat, np.float32), device=x.device))
    theta[:2, 2] *= 2.0
    theta[0, 2] += 1.0 / up / W
    theta[1, 2] += 1.0 / up / H
    theta[0, :] *= W / (W + p / up * 2)
    theta[1, :] *= H / (H + p / up * 2)
    g = _affine_grid(theta[:2, :3], N, H, W)
    y = upsample2d(x, f, up=up, padding=p)
    z = grid_sample_2d(y, g)
    m = torch.zeros_like(y)
    c = p * 2 + 1
    m[:, :, c:-c, c:-c] = 1.0
    return z, _grid_sample_nearest(m, g)


def apply_fractional_rotation(x, angle, a=3, **filter_kwargs):
    return apply_affine_transformation(x, rotation_matrix(angle), a=a, amax=a * 2,
                                       **filter_kwargs)


def apply_fractional_pseudo_rotation(x, angle, a=3, **filter_kwargs):
    """R^*_alpha: band-limit as if rotated, without rotating (ref :181-190)."""
    f = construct_affine_bandlimit_filter(rotation_matrix(-float(angle)), a=a, amax=a * 2,
                                          up=1, device=x.device, **filter_kwargs)
    y = filter2d(x, f)
    m = torch.zeros_like(y)
    c = f.shape[0] // 2
    m[:, :, c:-c, c:-c] = 1.0
    return y, m


@torch.no_grad()
def compute_equivariance_metrics(gen, key: np.ndarray, num_samples: int = 50_000,
                                 batch_size: int = 4, translate_max: float = 0.125,
                                 rotate_max: float = 1.0, compute_eqt_int: bool = False,
                                 compute_eqt_frac: bool = False, compute_eqr: bool = False,
                                 truncation_psi: float = 1.0):
    """-> PSNR (dB) per requested metric, in the reference's order (int,
    frac, rot). gen: a Generator3 on its device; key: a JAX key
    (jax_random.PRNGKey)."""
    assert compute_eqt_int or compute_eqt_frac or compute_eqr
    synthesis = getattr(gen, "synthesis", None)
    if not hasattr(getattr(synthesis, "input", None), "transform"):
        raise ValueError("Cannot compute equivariance metrics; the given generator does not "
                         "support user-specified image transformations")
    dev = next(gen.parameters()).device
    eye = np.eye(3, dtype=np.float32)

    def synth_pair(z, c, transform):
        ws = gen.mapping(z, c, truncation_psi=truncation_psi)
        # the identity pass resets the transform (ref :223)
        return (synthesis(ws, torch.tensor(eye, device=dev)),
                synthesis(ws, torch.tensor(transform, device=dev)))

    rng = np.random.default_rng(int(np.asarray(key)[-1]))
    res = gen.img_resolution
    sums, done = None, 0
    while done < num_samples:
        key, kz = jax_random.split(key)
        z = torch.from_numpy(jax_random.normal(kz, (batch_size, gen.z_dim))).to(dev)
        c = torch.zeros((batch_size, gen.c_dim), device=dev) if gen.c_dim > 0 else None
        s = []
        if compute_eqt_int:
            t = (rng.random(2) * 2 - 1) * translate_max
            t = np.round(t * res) / res
            m = eye.copy()
            m[:2, 2] = -t
            orig, img = synth_pair(z, c, m)
            ref, mask = apply_integer_translation(orig, t[0], t[1])
            s += [(ref - img).square() * mask, mask]
        if compute_eqt_frac:
            t = (rng.random(2) * 2 - 1) * translate_max
            m = eye.copy()
            m[:2, 2] = -t
            orig, img = synth_pair(z, c, m)
            ref, mask = apply_fractional_translation(orig, t[0], t[1])
            s += [(ref - img).square() * mask, mask]
        if compute_eqr:
            angle = float((rng.random() * 2 - 1) * (rotate_max * np.pi))
            orig, img = synth_pair(z, c, rotation_matrix(-angle))
            ref, ref_mask = apply_fractional_rotation(orig, angle)
            pseudo, pseudo_mask = apply_fractional_pseudo_rotation(img, angle)
            mask = ref_mask * pseudo_mask
            s += [(ref - pseudo).square() * mask, mask]
        batch_sums = np.stack([float(v.double().sum()) for v in s])
        sums = batch_sums if sums is None else sums + batch_sums
        done += batch_size
    mses = sums[0::2] / sums[1::2]
    psnrs = np.log10(2.0) * 20 - np.log10(mses) * 10
    return tuple(float(p) for p in psnrs)
