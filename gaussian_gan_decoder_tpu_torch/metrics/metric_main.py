"""Metric registry and sample streams — port of metrics/metric_main.py (the
reference's metrics/metric_main.py:44-155 and the feature loops of
metric_utils.py, with the eg3d fork's decoder path, eg3d/metrics/
metric_utils.py:286-322 and calc_metrics.py:57-100: samples go z, c ->
surface -> decode -> splat render).

Metrics take any `feature_fn` / `logits_fn` (the port's InceptionV3 with a
pytorch-fid state dict for published-comparable numbers, apps/
calc_metrics.py --inception; without it is50k reports NaN). KID and PR take
their distances on `device` (the card unless the caller names the CPU).

The streams draw z as the JAX package does, through utils/jax_random.py
(`fold_in`, `normal`), so a key gives JAX's latents; the draws JAX takes
from a key inside a render (the renderer's, the target's) come from a draws
object (utils/draws.py; None: a TorchDraws seeded from the key), at the
site `batch{i}` / `frame{i}` of each yielded batch.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..utils import jax_random
from ..utils.draws import draws_or_seeded
from .feature_stats import stats_for_iterator, to_host
from .frechet import fid_from_stats
from .kernel import kid_from_features
from .precision_recall import precision_recall

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn):
    _metric_dict[fn.__name__] = fn
    return fn


def list_metrics():
    return sorted(_metric_dict)


def calc_metric(metric: str, *, real_batches, gen_batches, feature_fn=None, logits_fn=None,
                **kwargs) -> Dict:
    """(ref metric_main.py:44-87) -> {'results': {...}, 'metric', 'total_time'}."""
    if metric not in _metric_dict:
        raise ValueError(f"unknown metric {metric}; have {list_metrics()}")
    t0 = time.time()
    results = _metric_dict[metric](real_batches=real_batches, gen_batches=gen_batches,
                                   feature_fn=feature_fn, logits_fn=logits_fn, **kwargs)
    return dict(results=results, metric=metric, total_time=time.time() - t0)


@register_metric
def fid50k_full(*, real_batches, gen_batches, feature_fn, num_items=50_000, **_):
    real = stats_for_iterator(real_batches, feature_fn, num_items)
    gen = stats_for_iterator(gen_batches, feature_fn, num_items)
    return {"fid50k_full": fid_from_stats(real, gen)}


def _all_features(real_batches, gen_batches, feature_fn, num_items):
    real = stats_for_iterator(real_batches, feature_fn, num_items, capture_all=True,
                              capture_mean_cov=False)
    gen = stats_for_iterator(gen_batches, feature_fn, num_items, capture_all=True,
                             capture_mean_cov=False)
    return real.get_all(), gen.get_all()


@register_metric
def kid50k_full(*, real_batches, gen_batches, feature_fn, num_items=50_000, device="cuda",
                **_):
    real, gen = _all_features(real_batches, gen_batches, feature_fn, num_items)
    return {"kid50k_full": kid_from_features(real, gen, device=device)}


@register_metric
def pr50k3_full(*, real_batches, gen_batches, feature_fn, num_items=50_000, device="cuda",
                **_):
    real, gen = _all_features(real_batches, gen_batches, feature_fn, num_items)
    p, r = precision_recall(real, gen, device=device)
    return {"pr50k3_full_precision": p, "pr50k3_full_recall": r}


@register_metric
def is50k(*, gen_batches, logits_fn=None, num_items=50_000, num_splits=10, **_):
    if logits_fn is None:
        return {"is50k_mean": float("nan"), "is50k_std": float("nan")}
    probs, n = [], 0
    for imgs in gen_batches:
        p = to_host(logits_fn(imgs))
        p = np.exp(p - p.max(axis=1, keepdims=True))
        p = p / p.sum(axis=1, keepdims=True)
        probs.append(p)
        n += p.shape[0]
        if n >= num_items:
            break
    probs = np.concatenate(probs)[:num_items]
    scores = []
    for s in np.array_split(probs, num_splits):
        kl = s * (np.log(s + 1e-12) - np.log(s.mean(axis=0, keepdims=True) + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return {"is50k_mean": float(np.mean(scores)), "is50k_std": float(np.std(scores))}


def _equivariance(flag, *, G=None, key=None, num_items=50_000, batch_size=4, **_):
    from .equivariance import compute_equivariance_metrics
    psnr, = compute_equivariance_metrics(G, key, num_samples=num_items, batch_size=batch_size,
                                         **{flag: True})
    return psnr


@register_metric
def eqt50k_int(**kw):
    """Integer-translation equivariance PSNR (ref eg3d/metrics/metric_main.py:141-146)."""
    return {"eqt50k_int": _equivariance("compute_eqt_int", **kw)}


@register_metric
def eqt50k_frac(**kw):
    """Fractional-translation equivariance PSNR (ref metric_main.py:148-153)."""
    return {"eqt50k_frac": _equivariance("compute_eqt_frac", **kw)}


@register_metric
def eqr50k(**kw):
    """Rotation equivariance PSNR (ref metric_main.py:155-160)."""
    return {"eqr50k": _equivariance("compute_eqr", **kw)}


# ----------------------------------------------------------------------------
# sample streams


def _render_draws(draws, n: int, nrr: int, rk, device):
    from ..neuralfield.renderer import RenderDraws
    return RenderDraws(draws.uniform((n, nrr * nrr, rk["depth_resolution"], 1)).to(device),
                       draws.uniform((n * nrr * nrr, rk["depth_resolution_importance"]))
                       .to(device))


@torch.no_grad()
def generator_image_batches(gen, key: np.ndarray, batch_size: int, c_source,
                            truncation_psi: float = 1.0, neural_rendering_resolution: int = 64,
                            draws=None):
    """Infinite stream of GAN images (N, 3, H, W) in [0, 255] on the
    generator's device (ref metric_utils.py compute_feature_stats_for_
    generator): batch i's z is JAX's normal(fold_in(fold_in(key, i), 0)),
    its renderer draws the draws object's `batch{i}` site."""
    dev = next(gen.parameters()).device
    draws = draws_or_seeded(draws, key, dev)
    i = 0
    while True:
        k = jax_random.fold_in(key, i)
        c = torch.tensor(np.asarray(next(c_source), np.float32)).to(dev)
        z = torch.from_numpy(jax_random.normal(jax_random.fold_in(k, 0),
                                               (batch_size, gen.z_dim))).to(dev)
        rd = _render_draws(draws.child(f"batch{i}"), batch_size, neural_rendering_resolution,
                           gen.rk, dev)
        out = gen.apply(z, c, truncation_psi=truncation_psi,
                        neural_rendering_resolution=neural_rendering_resolution, draws=rd)
        img = out["image"] if "image" in out else out["image_raw"]
        yield torch.clamp((img + 1) * 127.5, 0, 255)
        i += 1


@torch.no_grad()
def decoder_image_batches(decoder, frozen, target_cfg, key: np.ndarray, c_source,
                          image_size: int = 512, raster_backend: str = "xla", draws=None):
    """Decoder-FID stream (ref eg3d/metrics/metric_utils.py:286-322): frame i
    draws JAX's z (normal(fold_in(fold_in(key, i), 0))), samples the frozen
    generator's target surface at the stream's camera (the draws object's
    `frame{i}` site: its render and surface draws), decodes it and splats
    it (render_with_decoder, the 'xla' rasterizer by default, as JAX) ->
    (1, 3, H, W) in [0, 255] on the decoder's device."""
    from ..decoder.snapshot import render_with_decoder
    from ..decoder.target_pipeline import TargetDraws, TargetSamplerConfig, sample_target
    dev = next(decoder.parameters()).device
    cfg = target_cfg if target_cfg is not None else TargetSamplerConfig()
    draws = draws_or_seeded(draws, key, dev)
    i = 0
    while True:
        k = jax_random.fold_in(key, i)
        c = torch.tensor(np.asarray(next(c_source), np.float32)).to(dev)
        z = torch.from_numpy(jax_random.normal(jax_random.fold_in(k, 0),
                                               (1, frozen.z_dim))).to(dev)
        td = TargetDraws.fixed_camera(draws.child(f"frame{i}"), frozen, cfg, dev)
        t = sample_target(td, frozen, z, camera_params=c[:1], cfg=cfg)
        fov = 2 * math.atan(0.5 / float(c[0, 16]))
        img, _ = render_with_decoder(decoder, z, c[:1], c[0, :16].reshape(4, 4), t.vertices,
                                     fov, image_size=image_size, backend=raster_backend)
        yield torch.clamp(img * 255.0, 0, 255)[None]
        i += 1


@register_metric
def ppl2_wend(*, mapping_fn=None, synthesis_fn=None, dist_fn=None, key=None, c_source=None,
              num_samples=50_000, batch_size=8, epsilon=1e-4, z_dim=512, c_dim=25,
              device="cuda", **_):
    """Perceptual Path Length, W space, endpoint sampling (ref PanoHead/
    metrics/metric_main.py:121-126 + perceptual_path_length.py).

    mapping_fn(key, z, c) -> ws; synthesis_fn(ws, c) -> images (N, 3, H, W),
    both endpoints of a pair under the same c; dist_fn(a, b) -> (N,)
    perceptual distances. t = 0 exactly with a t + eps sibling; PPL is the
    mean of dist / eps^2 over the [1, 99] percentile band (the reference's
    lower / higher interpolation). z comes from JAX's key stream
    (jax_random: fold_in, split, normal) on `device`."""
    if mapping_fn is None or synthesis_fn is None or dist_fn is None:
        raise ValueError("ppl2_wend needs mapping_fn, synthesis_fn and dist_fn")
    from ..flagship import resolve_device
    dev = resolve_device(device)
    key = key if key is not None else jax_random.PRNGKey(0)
    dists = []
    for i in range(max(1, num_samples // batch_size)):
        k = jax_random.fold_in(key, i)
        kz0, kz1 = jax_random.split(k, 2)
        z0 = torch.from_numpy(jax_random.normal(kz0, (batch_size, z_dim))).to(dev)
        z1 = torch.from_numpy(jax_random.normal(kz1, (batch_size, z_dim))).to(dev)
        c = (torch.tensor(np.asarray(next(c_source), np.float32)).to(dev)
             if c_source is not None else torch.zeros((batch_size, c_dim), device=dev))
        w0, w1 = mapping_fn(k, z0, c), mapping_fn(k, z1, c)
        img0 = synthesis_fn(w0, c)
        img1 = synthesis_fn(w0 + (w1 - w0) * epsilon, c)
        dists.append(to_host(dist_fn(img0, img1)) / (epsilon ** 2))
    d = np.concatenate(dists)
    lo = np.percentile(d, 1, method="lower")
    hi = np.percentile(d, 99, method="higher")
    d = d[(d >= lo) & (d <= hi)]
    return {"ppl2_wend": float(d.mean())}
