"""JAX's default PRNG in numpy: `PRNGKey`, `random_bits`, `uniform` and
`normal` for float32, so that the port's apps draw the same
latent for a seed as the JAX package's (`jax.random.normal(PRNGKey(seed),
shape)`) without importing jax.

The implementation is the one jax 0.9 uses by default: the threefry2x32
hash (20 rounds, Salmon et al. 2011, as `jax._src.prng`), with
`jax_threefry_partitionable` on. Under that flag a draw of shape S hashes
the counters 0 .. prod(S)-1, split as a uint64 into (high, low) uint32
words, and a 32-bit draw is the XOR of the hash's two output words.

`uniform` takes the top 23 bits as the mantissa of a float in [1, 2), as
jax does; `normal` is sqrt(2) * erfinv(u) with u uniform on
(nextafter(-1, 0), 1), and erfinv is XLA's float32 polynomial (Giles,
"Approximating the erfinv function", the coefficients of XLA's ErfInv32),
evaluated in float32 in XLA's order, its multiply-adds fused as XLA's CPU
code fuses them. XLA's CPU log1p is its own approximation, not the C
library's, so a draw can differ from `jax.random.normal`'s on the CPU in
its last bits: at most 3 units in the last place over 2,000,000 draws,
98.7 % of them equal (tests/test_torch_jax_random.py holds the apps'
latents to 3 ulp). `uniform` is bit for bit.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of the counter words (x0, x1) under key (2,)
    uint32 -> two uint32 arrays of the counters' shape."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed): the seed's high and low 32 bits. A negative
    seed is taken modulo 2**64, as jax's int64 seed is bit-cast."""
    s = int(seed) % (1 << 64)
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def _counters(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    n = math.prod(shape)
    iota = np.arange(n, dtype=np.uint64)
    return ((iota >> np.uint64(32)).astype(np.uint32).reshape(shape),
            (iota & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape))


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits an element (jax's partitionable threefry)."""
    shape = tuple(int(s) for s in shape)
    c0, c1 = _counters(shape)
    b0, b1 = threefry2x32(key, c0, c1)
    return b0 ^ b1


def uniform(key: np.ndarray, shape: Sequence[int], minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


# XLA's ErfInv32 (Giles' single-precision polynomial): w = -log1p(-x*x);
# for w < 5 the first row in (w - 2.5), else the second in (sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """erfinv of float32 x in (-1, 1) by XLA's float32 polynomial."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    w64 = w.astype(np.float64)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # XLA's CPU code contracts c + p * w into one fused multiply-add: the
        # f32 product is exact in f64, so one f64 add and a rounding model it
        c = np.where(lt, np.float32(a), np.float32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w64).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == np.float32(1.0), x * np.finfo(np.float32).max, out)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """jax.random.normal(key, shape) at float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def seed_normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """jax.random.normal(jax.random.PRNGKey(seed), shape): the apps' latent
    for a seed."""
    return normal(PRNGKey(seed), shape)
