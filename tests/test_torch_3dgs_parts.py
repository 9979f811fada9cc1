"""The classic 3DGS parts of the port against the JAX package's, on the CPU:
spherical harmonics at degrees 0-3, the covariance builders, the banded
KNN, the point-cloud initialisation and the .ply codec at SH degree 3.

Inputs are seeded numpy draws, in float32 on both sides (JAX's x64 off).
Tolerances: the SH colours within 2e-6 absolute (values of order 1; the
same polynomial in the same order, only a fused multiply-add's rounding may
differ), degree 0 bit for bit with the decoder path's formula; rotations
and covariances within 1e-6 of their largest entry; the KNN's mean
distances within 1e-6 relative (the same candidates, only the sum of three
squares may round differently), and exact for 0.9 of a small cloud as
JAX's own test demands; create_from_points within 1e-6 relative; .ply
files byte for byte both ways."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.gaussians import model as jmodel
from gaussian_gan_decoder_tpu.gaussians import ply as jply
from gaussian_gan_decoder_tpu.gaussians import sh as jsh
from gaussian_gan_decoder_tpu.ops.knn import mean_sq_dist_to_knn as jknn
from gaussian_gan_decoder_tpu.splat import projection as jproj
from gaussian_gan_decoder_tpu_torch.gaussians import model, ply, sh
from gaussian_gan_decoder_tpu_torch.ops.knn import mean_sq_dist_to_knn
from gaussian_gan_decoder_tpu_torch.splat import projection
from _torch_threads import torch_threads  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_sh_degrees_match_jax():
    rng = np.random.RandomState(0)
    n = 500
    coef = rng.randn(n, 3, 16).astype(np.float32)
    means = rng.randn(n, 3).astype(np.float32)
    campos = np.array([0.3, -0.2, 2.5], np.float32)
    dirs = means - campos
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = torch.tensor
    for deg in range(4):
        got = sh.eval_sh(deg, t(coef), t(dirs)[:, None, :])
        want = jsh.eval_sh(deg, jnp.asarray(coef), jnp.asarray(dirs)[:, None, :])
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-6)
        got = sh.sh_to_color(deg, t(coef), t(means), t(campos))
        want = jsh.sh_to_color(deg, jnp.asarray(coef), jnp.asarray(means), jnp.asarray(campos))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-6)
        assert float(got.min()) >= 0.0 and bool((got == 0).any())   # the clamp bites
    # degree 0: the decoder path's colour, bit for bit, whatever the camera
    c0 = sh.sh_to_color(0, t(coef[:, :, :1]), t(means), t(campos))
    assert torch.equal(c0, torch.clamp(sh.SH_C0 * t(coef[:, :, 0]) + 0.5, min=0.0))
    rgb = rng.rand(n, 3).astype(np.float32)
    np.testing.assert_array_equal(_np(sh.rgb_to_sh(t(rgb))), np.asarray(jsh.rgb_to_sh(rgb)))
    np.testing.assert_array_equal(_np(sh.sh_to_rgb(t(rgb))), np.asarray(jsh.sh_to_rgb(rgb)))


def test_covariance_builders_match_jax():
    rng = np.random.RandomState(1)
    n = 400
    q = rng.randn(n, 4).astype(np.float32)
    s = np.exp(rng.randn(n, 3) * 0.5 - 3).astype(np.float32)
    for got, want in (
            (projection.build_rotation(torch.tensor(q)), jproj.build_rotation(jnp.asarray(q))),
            (projection.build_cov3d(torch.tensor(s), torch.tensor(q), 1.3),
             jproj.build_cov3d(jnp.asarray(s), jnp.asarray(q), 1.3))):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6 * np.abs(want).max())
    logs = rng.randn(n, 3).astype(np.float32) * 0.5 - 3
    scene = model.GaussianScene(torch.zeros(n, 3), torch.zeros(n, 1, 3),
                                torch.zeros(n, 0, 3), torch.tensor(logs), torch.tensor(q),
                                torch.zeros(n, 1), torch.ones(n, dtype=torch.bool))
    jscene = jmodel.GaussianScene(jnp.zeros((n, 3)), jnp.zeros((n, 1, 3)), jnp.zeros((n, 0, 3)),
                                  jnp.asarray(logs), jnp.asarray(q), jnp.zeros((n, 1)),
                                  jnp.ones(n, bool))
    got, want = model.build_covariance(scene, 0.7), np.asarray(jmodel.build_covariance(jscene, 0.7))
    assert got.shape == (n, 6)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_knn_matches_jax():
    rng = np.random.RandomState(2)
    for n, window in ((256, 64), (2000, 16)):
        pts = rng.randn(n, 3).astype(np.float32)
        got = _np(mean_sq_dist_to_knn(torch.tensor(pts), k=3, window=window))
        want = np.asarray(jknn(jnp.asarray(pts), k=3, window=window))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        if window == 64:
            # JAX's own check against the exact 3-NN (test_ops_pointwise.py)
            d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
            np.fill_diagonal(d2, np.inf)
            exact = np.sort(d2, axis=1)[:, :3].mean(axis=1)
            assert np.isclose(got, exact, rtol=1e-4).mean() > 0.9
            assert np.all(got >= exact - 1e-5)


def test_create_from_points_matches_jax():
    rng = np.random.RandomState(3)
    pts = (rng.rand(3000, 3).astype(np.float32) * 2.6 - 1.3)
    cols = rng.rand(3000, 3).astype(np.float32) * 1.2 - 0.1      # the clip bites
    for colors in (cols, None):
        got = model.create_from_points(torch.tensor(pts),
                                       None if colors is None else torch.tensor(colors),
                                       sh_degree=3)
        want = jmodel.create_from_points(jnp.asarray(pts),
                                         None if colors is None else jnp.asarray(colors),
                                         sh_degree=3)
        for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
                  "valid"):
            g, w = _np(getattr(got, f)), np.asarray(getattr(want, f))
            assert g.shape == w.shape, f
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f)
        assert (got.max_sh_degree, got.active_sh_degree) == (3, 0)


def test_ply_round_trips_across_packages(tmp_path):
    rng = np.random.RandomState(4)
    n = 50
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    arrs = (f(n, 3), f(n, 1, 3), f(n, 15, 3), f(n, 3), f(n, 4), f(n, 1))
    valid = rng.rand(n) > 0.3
    for active in range(4):
        tscene = model.GaussianScene(*(torch.tensor(a) for a in arrs), torch.tensor(valid),
                                     max_sh_degree=3, active_sh_degree=active)
        jscene = jmodel.GaussianScene(*(jnp.asarray(a) for a in arrs), jnp.asarray(valid),
                                      max_sh_degree=3, active_sh_degree=active)
        tp, jp = str(tmp_path / f"t{active}.ply"), str(tmp_path / f"j{active}.ply")
        ply.save_ply(tscene, tp)
        jply.save_ply(jscene, jp)
        assert open(tp, "rb").read() == open(jp, "rb").read(), active
        # each package reads the other's file to the same values
        back_t, back_j = ply.load_ply(jp, max_sh_degree=3), jply.load_ply(tp, max_sh_degree=3)
        for name in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
            a, b = _np(getattr(back_t, name)), np.asarray(getattr(back_j, name))
            np.testing.assert_array_equal(a, b, err_msg=name)
            want = getattr(tscene, name)[torch.tensor(valid)].numpy()
            if name == "features_rest" and active == 0:
                want = np.zeros_like(want)     # the degree-0 layout has no f_rest
            np.testing.assert_array_equal(a, want, err_msg=name)
        assert back_t.active_sh_degree == back_j.active_sh_degree == 3
