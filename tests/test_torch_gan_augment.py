"""The port's ADA pipe (train/augment.py) against the JAX package's, on
JAX's draws (tests/_gan_draws.py feeds the port the 40 keys JAX's
augment_pipe splits): the default geometric + colour pipe, the image
filter bank with noise and cutout, and the alias-free warp (upsample2d ->
grid sample -> downsample2d); p = 0 is the identity; ada_update.

Tolerances: images within 5e-6 absolute at p 0.7 (unit-scale images; f32
3x3 and 4x4 matrix products and the bilinear taps in another order), the
identity bit for bit (exactly equal to the input, as in JAX), ada_update
bit for bit (f32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.train import augment as jaug
from gaussian_gan_decoder_tpu_torch.train import augment as taug
from _gan_draws import seq
from _torch_threads import torch_threads  # noqa: F401  (autouse)

CONFIGS = {
    "default": {},
    "filters_noise_cutout": {"imgfilter": 1.0, "noise": 1.0, "cutout": 1.0},
    "alias_free": {"alias_free": True},
}


def _images(seed=0, n=3, c=3, size=16):
    return (np.random.RandomState(seed).rand(n, c, size, size) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_augment_pipe_matches_jax(name):
    """p 0.7 (every augmentation likely), 4-channel images (the pipe keeps
    channels past rgb), one key."""
    with jax.enable_x64(False):
        jcfg = jaug.AugmentConfig(**CONFIGS[name])
        x, key = _images(c=4), jax.random.PRNGKey(11)
        ref = np.asarray(jaug.augment_pipe(key, jnp.asarray(x), jnp.float32(0.7), jcfg))
        got = taug.augment_pipe(seq(key, 40), torch.tensor(x), 0.7,
                                taug.AugmentConfig(**dataclasses.asdict(jcfg))).numpy()
    assert np.abs(ref - x).max() > 0.1    # the draws changed the images
    np.testing.assert_allclose(got, ref, atol=5e-6)


def test_identity_and_ada_update():
    """At p = 0 the pipe returns its input exactly on both sides (the
    default config; the alias-free warp is the identity only to its
    filters' rounding, 4e-6, on both sides); ada_update raises, lowers and
    clips p as JAX's does, bit for bit."""
    with jax.enable_x64(False):
        x, key = _images(1), jax.random.PRNGKey(2)
        got = taug.augment_pipe(seq(key, 40), torch.tensor(x), 0.0).numpy()
        assert np.array_equal(got, x)
        assert np.array_equal(np.asarray(jaug.augment_pipe(key, jnp.asarray(x), 0.0)), x)
        af = taug.augment_pipe(seq(key, 40), torch.tensor(x), 0.0,
                               taug.AugmentConfig(alias_free=True)).numpy()
        jaf = np.asarray(jaug.augment_pipe(key, jnp.asarray(x), 0.0,
                                           jaug.AugmentConfig(alias_free=True)))
        assert np.abs(af - x).max() < 1e-5 and np.abs(jaf - x).max() < 1e-5
        for p, rt, batch in ((0.2, 1.0, 4), (0.2, -1.0, 4), (0.0, 0.0, 32), (1.0, 1.0, 64),
                             (0.5, 0.6, 8)):
            ref = np.float32(jaug.ada_update(jnp.float32(p), jnp.float32(rt), batch))
            assert taug.ada_update(np.float32(p), rt, batch) == ref
