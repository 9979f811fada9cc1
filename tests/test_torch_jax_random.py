"""The port's numpy copy of JAX's default PRNG (utils/jax_random.py)
against jax.random, and the apps' latents drawn through it.

Tolerances: PRNGKey and uniform bit for bit. normal within 3 units
in the last place of float32 (ULP): XLA's CPU log1p inside erf_inv is its
own approximation, which numpy's does not reproduce bit for bit; over
2,000,000 draws the numpy copy is at most 3 ULP off and 98.7 % of draws are
equal. The apps' latents (gen_samples, gen_shapes, gen_videos) are held
to the same 3 ULP against jax.random.normal(PRNGKey(seed), ...)."""
import jax
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu_torch.apps import gen_samples, gen_videos
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.utils import jax_random
from _torch_threads import torch_threads  # noqa: F401  (autouse)

MAX_ULP = 3


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
def test_seed_latent_matches_jax(seed):
    """z at z_dim 512 for a seed, as gen_samples and gen_shapes draw it
    ((1, 512)), within 3 ULP; the key and a uniform draw bit for bit."""
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(seed)
        assert np.array_equal(np.asarray(key), jax_random.PRNGKey(seed))
        assert np.array_equal(np.asarray(jax.random.uniform(key, (4, 33))),
                              jax_random.uniform(jax_random.PRNGKey(seed), (4, 33)))
        ref = np.asarray(jax.random.normal(key, (1, 512)))
    got = jax_random.seed_normal(seed, (1, 512))
    assert got.dtype == np.float32 and got.shape == (1, 512)
    assert _ulps(got, ref).max() <= MAX_ULP


def test_app_latents_match_jax(monkeypatch, tmp_path):
    """gen_videos' latents (z_dim,) a seed, and the z gen_samples --smoke
    hands its generator, equal JAX's apps' draws within 3 ULP."""
    seeds = [0, 3]
    with jax.enable_x64(False):
        refs = [np.asarray(jax.random.normal(jax.random.PRNGKey(s), (512,))) for s in seeds]
        ref_smoke = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1, 32)))
    zs = gen_videos.seed_latents(seeds, 512)
    assert tuple(zs.shape) == (2, 512)
    for z, ref in zip(zs, refs):
        assert _ulps(z.numpy(), ref).max() <= MAX_ULP

    seen = []
    mapping = TriPlaneGenerator.mapping

    def spy(self, z, c, *a, **k):
        seen.append(z.detach().clone())
        return mapping(self, z, c, *a, **k)

    monkeypatch.setattr(TriPlaneGenerator, "mapping", spy)
    gen_samples.main(["--smoke", "--force_cpu", "--seeds", "5", "--yaws", "0",
                      "--outdir", str(tmp_path / "s")])
    assert seen and _ulps(seen[0].numpy(), ref_smoke).max() <= MAX_ULP
    assert torch.equal(seen[0], torch.from_numpy(jax_random.seed_normal(5, (1, 32))))
