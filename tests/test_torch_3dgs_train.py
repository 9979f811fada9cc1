"""The port's classic 3DGS trainer against the JAX package's, on the CPU:
densify_and_prune with JAX's draws, the train step (loss, gradients, Adam
update, densification statistics) against jax.value_and_grad + optax, and
densify_step's Adam surgery on one step's moments.

Capacity 256 with 160 seeded points at 32^2, float32 on both sides (JAX's
x64 off). Tolerances, with the reasons:
  * densify_and_prune on the same scene: valid mask, slots and stats
    equal; copied rows bit for bit; the split children's positions and
    log-scales within 1e-6 of their tensor's largest (a rotation product
    and a log of an exp, rounded apart);
  * the step: loss and L1 within 1e-5 relative; Adam's first moments
    (0.1 x the gradient) within 1e-5 of each tensor's largest, second
    moments within 2e-5 of theirs; the screen-space gradient sums within
    1e-5 of their largest, visibility counts and radii equal; parameters
    within 2 lr + one f32 spacing (Adam's first update is lr sign(g), so a
    gradient at rounding level may flip), and within 1e-3 lr + one spacing
    where the gradient is at least 1e-2 of its tensor's largest;
  * the step at SH degree 1 and the densify step start from JAX's state
    copied into the port's, so each is held alone.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.gaussians import densify as jdensify
from gaussian_gan_decoder_tpu.gaussians import model as jmodel
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.splat.rasterize import RasterizeConfig as JRCfg
from gaussian_gan_decoder_tpu.train import gaussian_splatting as jgs
from gaussian_gan_decoder_tpu_torch.gaussians import densify
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import Camera
from gaussian_gan_decoder_tpu_torch.gaussians.model import GaussianScene
from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig
from gaussian_gan_decoder_tpu_torch.train import gaussian_splatting as gs
from _torch_threads import torch_threads  # noqa: F401  (autouse)

SIZE, CAP, NPTS = 32, 256, 160
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
LABELS = dict(xyz="xyz", features_dc="f_dc", features_rest="f_rest", scaling="scaling",
              rotation="rotation", opacity="opacity")
RCFG = dict(tile_size=16, max_pairs=2 ** 12, tile_capacity=128, chunk=32)


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jax_draws(key, n):
    k0, k1 = jax.random.split(key)
    return tuple(torch.tensor(np.asarray(jax.random.normal(k, (n, 3)))) for k in (k0, k1))


def _densify_case(seed, cap, n_valid):
    """A scene at capacity: the first n_valid slots valid, mixed scales
    around percent_dense * extent, some transparent; the statistics."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    valid = np.zeros(cap, bool)
    valid[:n_valid] = True
    opac = f(cap, 1)
    opac[rng.rand(cap) < 0.1] = -8.0                                # pruned by opacity
    arrs = dict(xyz=f(cap, 3), features_dc=f(cap, 1, 3), features_rest=f(cap, 15, 3),
                scaling=(np.log(0.01) + f(cap, 3) * 0.7).astype(np.float32),
                rotation=f(cap, 4), opacity=opac)
    stats = (np.abs(f(cap)) * 3e-4, rng.randint(0, 3, cap).astype(np.float32),
             (rng.rand(cap) * 40).astype(np.float32))
    return arrs, valid, stats


def test_densify_and_prune_matches_jax(monkeypatch):
    for seed, cap, n_valid, mss in ((0, 256, 150, None), (1, 96, 94, 35.0)):
        arrs, valid, (ga, dn, mr) = _densify_case(seed, cap, n_valid)
        key = jax.random.PRNGKey(seed)
        jscene = jmodel.GaussianScene(*(jnp.asarray(arrs[f]) for f in FIELDS), jnp.asarray(valid),
                                      max_sh_degree=3)
        tscene = GaussianScene(*(torch.tensor(arrs[f]) for f in FIELDS), torch.tensor(valid),
                               max_sh_degree=3)
        want, wstats = jdensify.densify_and_prune(jscene, jnp.asarray(ga), jnp.asarray(dn),
                                                  jnp.asarray(mr), key, extent=1.5,
                                                  max_screen_size=mss)
        draws = _jax_draws(key, cap)
        monkeypatch.setattr(densify, "split_draws", lambda k, n, dt: draws)
        got, stats = densify.densify_and_prune(tscene, torch.tensor(ga), torch.tensor(dn),
                                               torch.tensor(mr), torch.Generator(), extent=1.5,
                                               max_screen_size=mss)
        assert tuple(int(v) for v in stats) == tuple(int(v) for v in wstats), (stats, wstats)
        assert int(stats.n_cloned) > 0 and int(stats.n_split) > 0 and int(stats.n_pruned) > 0
        assert (int(stats.n_dropped) > 0) == (cap == 96)
        np.testing.assert_array_equal(_np(got.valid), np.asarray(want.valid))
        for f in FIELDS:
            g, w = _np(getattr(got, f)), np.asarray(getattr(want, f))
            if f in ("xyz", "scaling"):       # the split children's, computed
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=f)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f)
        # the inputs are untouched
        assert torch.equal(tscene.xyz, torch.tensor(arrs["xyz"]))


JCFG = jgs.GSOptimizationConfig(capacity=CAP, sh_degree=1, densify_grad_threshold=1e-9)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's jitted step and its optax transform, built once for the module
    (each SH degree compiles once)."""
    step, tx = jgs.make_train_step(JCFG, JRCfg(**RCFG), SIZE, 1.3)
    return jax.jit(step, static_argnames=("sh_degree",)), tx


def _setup():
    rng = np.random.RandomState(7)
    pts = ((rng.rand(NPTS, 3) - 0.5) * 0.5).astype(np.float32)
    cols = rng.rand(NPTS, 3).astype(np.float32)
    cfg = gs.GSOptimizationConfig(capacity=CAP, sh_degree=1, densify_grad_threshold=1e-9)
    jcfg = JCFG
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.diag([-1.0, 1.0, -1.0])
    c2w[2, 3] = 2.7
    jc = jmake_camera(SIZE, 0.5, jnp.asarray(c2w))
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    cam = Camera(t(jc.world_view_transform), t(jc.full_proj_transform), t(jc.camera_center),
                 float(jc.tanfovx), float(jc.tanfovy), SIZE, SIZE)
    gt = rng.rand(3, SIZE, SIZE).astype(np.float32)
    # visible, anisotropic Gaussians: log-scales about -3 on the real points
    # (JAX's own test sets -3), so that the rotations have gradients
    logs = (-3.0 + 0.3 * rng.randn(NPTS, 3)).astype(np.float32)
    jstate = jgs.init_gs_state(pts, cols, jcfg, spatial_lr_scale=1.3)
    jstate = jstate._replace(scene=jstate.scene._replace(
        scaling=jstate.scene.scaling.at[:NPTS].set(logs)))
    state = gs.init_gs_state(pts, cols, cfg, spatial_lr_scale=1.3)
    with torch.no_grad():
        state.scene.scaling[:NPTS] = torch.tensor(logs)
    return cfg, jcfg, jc, cam, gt, jstate, state


def _moments(jopt, name):
    st = jopt.inner_states[LABELS[name]].inner_state[0]
    return np.asarray(st.mu[name]), np.asarray(st.nu[name])


def _hold_step(state, jstate, jprev, out, jout, lrs):
    """Hold the port's state and metrics after a step against JAX's."""
    for k in ("loss", "l1"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-5, err_msg=k)
    assert int(out["n_valid"]) == int(jout["n_valid"])
    for name in FIELDS:
        p = getattr(state.scene, name)
        st = state.optimizer.state[p]
        mu, nu = _moments(jstate.opt_state, name)
        np.testing.assert_allclose(_np(st["exp_avg"]), mu, rtol=0,
                                   atol=1e-5 * max(np.abs(mu).max(), 1e-30), err_msg=name)
        np.testing.assert_allclose(_np(st["exp_avg_sq"]), nu, rtol=0,
                                   atol=2e-5 * max(np.abs(nu).max(), 1e-30), err_msg=name)
        w = np.asarray(getattr(jstate.scene, name))
        d = np.abs(_np(p) - w)
        spacing = np.spacing(np.abs(w).astype(np.float32))
        assert np.all(d <= 2 * lrs[name] + spacing), name
        big = np.abs(mu) >= 1e-2 * np.abs(mu).max()
        assert np.all(d[big] <= 1e-3 * lrs[name] + spacing[big]), name
        moved = np.abs(w - np.asarray(getattr(jprev.scene, name))).max()
        assert moved > 0 or name == "features_rest", name
    ga = np.asarray(jstate.grad_accum)
    np.testing.assert_allclose(_np(state.grad_accum), ga, rtol=0, atol=1e-5 * ga.max())
    assert ga.max() > 0
    np.testing.assert_array_equal(_np(state.denom), np.asarray(jstate.denom))
    np.testing.assert_array_equal(_np(state.max_radii2d), np.asarray(jstate.max_radii2d))
    assert state.step == int(jstate.step)


def _copy_jax_state(state, jstate):
    """The JAX state's parameters, mask, statistics and moments, written
    into the port's state (whose optimizer has taken a step)."""
    with torch.no_grad():
        for name in FIELDS:
            p = getattr(state.scene, name)
            p.copy_(torch.tensor(np.asarray(getattr(jstate.scene, name))))
            mu, nu = _moments(jstate.opt_state, name)
            state.optimizer.state[p]["exp_avg"].copy_(torch.tensor(mu))
            state.optimizer.state[p]["exp_avg_sq"].copy_(torch.tensor(nu))
        state.scene.valid.copy_(torch.tensor(np.asarray(jstate.scene.valid)))
    return state._replace(**{k: torch.tensor(np.asarray(getattr(jstate, k)))
                             for k in ("grad_accum", "denom", "max_radii2d")})


def test_train_step_matches_optax():
    cfg, jcfg, jc, cam, gt, jstate, state = _setup()
    jstep, _ = _jax_step()
    step = gs.make_train_step(cfg, RasterizeConfig(**RCFG), SIZE, 1.3)
    sched = gs.xyz_schedule(cfg, 1.3)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    for deg in (0, 1):
        lrs = dict(xyz=sched(state.step), features_dc=cfg.feature_lr,
                   features_rest=cfg.feature_lr / 20, scaling=cfg.scaling_lr,
                   rotation=cfg.rotation_lr, opacity=cfg.opacity_lr)
        jnext, jout = jstep(jstate, jc, jnp.asarray(gt), jnp.asarray(bg), sh_degree=deg)
        state, out = step(state, cam, torch.tensor(gt), torch.tensor(bg), sh_degree=deg)
        _hold_step(state, jnext, jstate, out, jout, lrs)
        # the next step starts from JAX's state in both packages
        jstate = jnext
        state = _copy_jax_state(state, jstate)
    assert state.optimizer.param_groups[0]["lr"] == sched(1)


def test_densify_step_and_adam_reset_match_jax(monkeypatch):
    """One step, then densify_step on the same state in both packages: the
    scene, the reset statistics and the moments after the surgery."""
    cfg, jcfg, jc, cam, gt, jstate, state = _setup()
    jstep, tx = _jax_step()
    bg = np.zeros(3, np.float32)
    jstate, _ = jstep(jstate, jc, jnp.asarray(gt), jnp.asarray(bg), sh_degree=0)
    state, _ = gs.make_train_step(cfg, RasterizeConfig(**RCFG), SIZE, 1.3)(
        state, cam, torch.tensor(gt), torch.tensor(bg), sh_degree=0)
    state = _copy_jax_state(state, jstate)
    key = jax.random.PRNGKey(3)
    want, wstats = jgs.densify_step(jstate, key, jcfg, extent=1.0, max_screen_size=None, tx=tx)
    draws = _jax_draws(key, CAP)
    monkeypatch.setattr(densify, "split_draws", lambda k, n, dt: draws)
    params = [getattr(state.scene, f) for f in FIELDS]
    got, stats = gs.densify_step(state, torch.Generator(), cfg, 1.0, None)
    assert tuple(int(v) for v in stats) == tuple(int(v) for v in wstats)
    assert int(stats.n_cloned) + int(stats.n_split) > 0
    touched = np.asarray(want.scene.valid != jstate.scene.valid)
    assert touched.any()
    np.testing.assert_array_equal(_np(got.scene.valid), np.asarray(want.scene.valid))
    for name, p in zip(FIELDS, params):
        assert getattr(got.scene, name) is p           # the optimizer's tensors, updated
        w = np.asarray(getattr(want.scene, name))
        np.testing.assert_allclose(_np(p), w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=name)
        mu, nu = _moments(want.opt_state, name)
        st = got.optimizer.state[p]
        np.testing.assert_array_equal(_np(st["exp_avg"]), mu, err_msg=name)
        np.testing.assert_array_equal(_np(st["exp_avg_sq"]), nu, err_msg=name)
        assert not mu[touched].any() and (name == "features_rest" or mu[~touched].any())
    for k in ("grad_accum", "denom", "max_radii2d"):
        assert not getattr(got, k).any()
