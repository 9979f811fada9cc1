"""The port's differentiable f32 tile rasterizer (splat/rasterize.py::
rasterize, the JAX package's 'xla' backend) and its all-pairs oracle
against the JAX package's, on the CPU.

About 300 seeded Gaussians on a 64^2 frame with 16-pixel tiles, the camera
of both sides built from the JAX camera's own matrices. rasterize: render
and alpha within rtol 1e-5 and atol 1e-6, radii and n_dropped equal, under
the JAX defaults and under budgets small enough to bind (a max_pairs that
drops pairs, n_dropped > 0, and a tile_capacity that cuts tiles); under
both, its VJP with respect to means, scales, rotations, opacities and
colours under one shared cotangent on the render, each within 1e-5 of the
largest gradient of that input. reference_rasterize within the same image
tolerance on about 50 Gaussians. render_simple('xla') against the port's
render_simple('pallas_diff') (K4 / K5's plain versions) on a set with no
depth ties: within 1e-4 where the training rule stops a pixel (T below
1e-4), within 1e-5 elsewhere. The JAX side runs in float32 (x64 off)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.splat.rasterize import RasterizeConfig as JRCfg
from gaussian_gan_decoder_tpu.splat.rasterize import rasterize as jrasterize
from gaussian_gan_decoder_tpu.splat.rasterize import reference_rasterize as jreference
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import Camera
from gaussian_gan_decoder_tpu_torch.splat.rasterize import (
    RasterizeConfig, rasterize, reference_rasterize, render_simple)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

SIZE, N = 64, 300
CASES = {"defaults": dict(),
         "budgets": dict(max_pairs=1200, tile_capacity=64, chunk=32)}


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _cameras(size=SIZE):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.diag([-1.0, 1.0, -1.0])
    c2w[2, 3] = 2.7
    jc = jmake_camera(size, 0.227, jnp.asarray(c2w))
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    return jc, Camera(t(jc.world_view_transform), t(jc.full_proj_transform),
                      t(jc.camera_center), float(jc.tanfovx), float(jc.tanfovy), size, size)


def _gaussians(seed, n=N):
    """(means, scales, rotations, opacities, colors) as float32 numpy."""
    rng = np.random.RandomState(seed)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return (f((rng.rand(n, 3) - 0.5) * 0.4), f(np.exp(rng.randn(n, 3) * 0.3 - 3.5)),
            f(rng.randn(n, 4)), f(1.0 / (1.0 + np.exp(-rng.randn(n)))), f(rng.rand(n, 3)))


def _rel_grad(got, ref):
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_rasterize_matches_jax(case):
    jc, cam = _cameras()
    g = _gaussians(0)
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    jcfg = JRCfg(tile_size=16, **CASES[case])
    ref = jax.jit(lambda *a: jrasterize(jc, *a[:4], colors_precomp=a[4], bg=a[5],
                                               config=jcfg))(*g, bg)
    out = rasterize(cam, *(torch.tensor(a) for a in g[:4]), colors_precomp=torch.tensor(g[4]),
                    bg=torch.tensor(bg), config=RasterizeConfig(**CASES[case]))
    print(f"{case}: n_dropped {out['n_dropped']} (JAX {int(ref['n_dropped'])}), "
          f"{out['n_pairs']} pairs blended")
    assert out["n_dropped"] == int(ref["n_dropped"])
    assert (out["n_dropped"] > 0) == (case == "budgets")
    for k in ("render", "alpha"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out["radii"].numpy(), np.asarray(ref["radii"]))
    np.testing.assert_array_equal(out["visibility_filter"].numpy(),
                                  np.asarray(ref["visibility_filter"]))
    assert float(out["render"].std()) > 0.02


def test_rasterize_vjp_matches_jax():
    jc, cam = _cameras()
    g = _gaussians(1)
    bg = np.array([0.5, 0.5, 0.5], np.float32)
    cot = np.random.RandomState(2).randn(3, SIZE, SIZE).astype(np.float32)
    for case, kw in CASES.items():
        jcfg = JRCfg(tile_size=16, **kw)

        def jrender(*a):
            return jrasterize(jc, *a[:4], colors_precomp=a[4], bg=jnp.asarray(bg),
                              config=jcfg)["render"]

        _, vjp = jax.vjp(jax.jit(jrender), *(jnp.asarray(a) for a in g))
        jgrads = jax.jit(vjp)(jnp.asarray(cot))
        ts = [torch.tensor(a, requires_grad=True) for a in g]
        out = rasterize(cam, *ts[:4], colors_precomp=ts[4], bg=torch.tensor(bg),
                        config=RasterizeConfig(**kw))
        out["render"].backward(torch.tensor(cot))
        names = ("means", "scales", "rotations", "opacities", "colors")
        for name, t, jg in zip(names, ts, jgrads):
            err = _rel_grad(t.grad.numpy(), jg)
            print(f"{case} d{name}: {err:.2e} of the largest")
            assert err <= 1e-5, (case, name, err)
            assert np.abs(np.asarray(jg)).max() > 0


def test_reference_rasterize_matches_jax():
    jc, cam = _cameras()
    g = _gaussians(3, 50)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref = jax.jit(lambda *a: jreference(jc, *a))(*g, bg)
    got = reference_rasterize(cam, *(torch.tensor(a) for a in g), torch.tensor(bg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert float(got.std()) > 0.01


def test_render_simple_xla_matches_pallas_diff():
    """The 'xla' rasterizer and the training blend's forward on the same
    decoded Gaussians, no two at the same depth."""
    _, cam = _cameras()
    rng = np.random.RandomState(4)
    n = 400
    xyz = (rng.rand(n, 3) - 0.5) * 0.4
    xyz[:, 2] = np.linspace(-0.2, 0.2, n)[rng.permutation(n)]    # distinct depths
    t = lambda a: torch.tensor(a.astype(np.float32))  # noqa: E731
    decoded = {"xyz": t(xyz), "scale": t(rng.randn(n, 3) * 0.3 - 3.5),
               "rotation": t(rng.randn(n, 4)), "opacity": t(rng.randn(n, 1)),
               "color": t(rng.randn(n, 3))}
    bg = torch.tensor([0.2, 0.3, 0.4])
    xla = render_simple(cam, decoded, bg, backend="xla")
    ref = render_simple(cam, decoded, bg)
    d = (xla["render"] - ref["render"]).abs()
    live = ref["alpha"][0] < 1 - 1e-4
    print(f"xla vs pallas_diff: max |d| {float(d.max()):.3e}, on the pixels not stopped "
          f"{float(d[:, live].max()):.3e}; {xla['n_pairs']} pairs")
    assert xla["n_pairs"] == ref["n_pairs"] > 500 and xla["n_dropped"] == 0
    assert float(d.max()) <= 1e-4 and float(d[:, live].max()) <= 1e-5
    assert torch.equal(xla["visibility_filter"], ref["visibility_filter"])
