"""Frechet distance (FID) — a copy of the JAX package's metrics/frechet.py
(ref PanoHead/metrics/frechet_inception_distance.py): scipy's sqrtm on the
host, in float64. Its `disp` keyword is left out (newer scipy dropped it),
and where newer scipy's root of a singular product is NaN the product is
taken again with 1e-6 on both diagonals, as pytorch-fid does."""
from __future__ import annotations

import numpy as np
import scipy.linalg

from .feature_stats import FeatureStats


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    m = np.square(mu1 - mu2).sum()
    # sqrtm's `disp` keyword (the JAX package passes disp=False for the root
    # alone) is gone from newer scipy; without it both return the root
    s = scipy.linalg.sqrtm(np.dot(cov1, cov2))
    if not np.isfinite(s).all():
        # newer scipy returns NaN for a singular product (fewer items than
        # features): pytorch-fid's remedy, eps on both diagonals
        off = np.eye(cov1.shape[0]) * 1e-6
        s = scipy.linalg.sqrtm(np.dot(cov1 + off, cov2 + off))
    return float(np.real(m + np.trace(cov1 + cov2 - s * 2)))


def fid_from_stats(real: FeatureStats, gen: FeatureStats) -> float:
    mu_r, cov_r = real.get_mean_cov()
    mu_g, cov_g = gen.get_mean_cov()
    return frechet_distance(mu_g, cov_g, mu_r, cov_r)
