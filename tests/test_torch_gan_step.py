"""The port's GAN step (train/gan.py) against the JAX package's
make_gan_train_step at the JAX CLI's smoke size (z/w 32, 16² tri-grid,
16² images, D channel_base 256 / channel_max 32, batch 2): the G loss and
the D loss, their metrics and every gradient, against jax.value_and_grad
of the step's own loss functions (read from the JAX step's closure) on
JAX's weights and JAX's draws (tests/_gan_draws.py), at step 0 (lazy
regularisation on: density TV, camera-translation, R1 on image, raw and
mask) and step 1 (off), for PanoHead ('mask_dual' D) and EG3D ('dual' D);
then one whole port step: Adam on equal gradients against optax, the EMA
against JAX's formula, the phases' gradients kept apart.

Tolerances: losses and metrics within 1e-5 relative; each tensor's
gradient within 1e-2 of that tensor's largest JAX gradient (the density
term's renders and the double backward sum in other orders; seen: 2.8e-3
PanoHead G, 3.7e-4 D); Adam's update (lr 2.4e-3;
one update with b1 = 0 is lr · g / (|g| + eps), so this holds only on the
same gradients): the updated tensors within 2 ULP (rtol 2.4e-7) + 1e-7;
the EMA within 1e-7."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_gan_decoder_tpu.models.discriminator import Discriminator as JD
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JG
from gaussian_gan_decoder_tpu.port.torch_export import flatten_params, generator_state_from_params
from gaussian_gan_decoder_tpu.train import gan as jgan
from gaussian_gan_decoder_tpu_torch.models.discriminator import Discriminator
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.port.from_jax import (load_discriminator_state,
                                                          load_generator_state)
from gaussian_gan_decoder_tpu_torch.train import gan
from gaussian_gan_decoder_tpu_torch.utils.draws import TorchDraws
from _gan_draws import gan_step_draws
from _torch_threads import torch_threads  # noqa: F401  (autouse)

RK = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4}
B = 2
# XLA's CPU backend without its optimisation passes compiles these
# programs in about half the time; the values are the same to f32 rounding
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn):
    return jax.jit(fn, compiler_options=FAST)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _build(variant):
    """JAX's and the port's networks on JAX's init weights, the two
    configs, and JAX's loss functions under jax.jit (do_reg traced)."""
    gkw = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=32, variant=variant,
               without_sr=True, channel_base=512, channel_max=32)
    dkw = dict(c_dim=25, img_resolution=16, img_channels=3,
               mode="mask_dual" if variant == "panohead" else "dual", channel_base=256,
               channel_max=32, num_fp16_res=0, conv_clamp=None, seg_resolution=8,
               mbstd_group_size=2)
    with jax.enable_x64(False):
        jg, jd = JG(rendering_kwargs=tuple(RK.items()), **gkw), JD(**dkw)
        gp, dp = _jit(jg.init)(jax.random.PRNGKey(0)), _jit(jd.init)(jax.random.PRNGKey(1))
        kw = dict(neural_rendering_resolution_initial=16, batch_size=B,
                  trans_reg=10.0 if variant == "panohead" else 0.0)
        jcfg = jgan.GANLossConfig(**kw)
        jstep, _ = jgan.make_gan_train_step(jg, jd, jcfg)
        free = dict(zip(jstep.__code__.co_freevars, (c.cell_contents for c in jstep.__closure__)))
        g_fn = _jit(jax.value_and_grad(free["g_loss_fn"], has_aux=True))
        d_fn = _jit(jax.value_and_grad(free["d_loss_fn"], has_aux=True))
    G, D = TriPlaneGenerator(rendering_kwargs=RK, **gkw), Discriminator(**dkw)
    load_generator_state(G, generator_state_from_params(gp))
    load_discriminator_state(D, flatten_params(dp))
    rng = np.random.RandomState(0)
    data = dict(z=rng.randn(B, 32), c=rng.randn(B, 25) * 0.1,
                image=rng.rand(B, 3, 16, 16) * 2 - 1, image_raw=rng.rand(B, 3, 16, 16) * 2 - 1,
                image_mask=rng.rand(B, 1, 16, 16))
    data = {k: v.astype(np.float32) for k, v in data.items()}
    return dict(jg=jg, jd=jd, gp=gp, dp=dp, g_fn=g_fn, d_fn=d_fn, G=G, D=D, data=data,
                cfg=gan.GANLossConfig(**kw), jcfg=jcfg)


@pytest.fixture(scope="module")
def nets():
    return {}


def _get(nets, variant):
    if variant not in nets:
        nets[variant] = _build(variant)
    return nets[variant]


def _check(loss, metrics, grads, names, jl, jm, jflat):
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        assert abs(float(metrics[k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1e-3), k
    for name, g in zip(names, grads):
        ref = np.asarray(jflat[name])
        got = np.zeros_like(ref) if g is None else g.numpy().reshape(ref.shape)
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max(), name


@pytest.mark.parametrize("variant,phase", [("panohead", "G"), ("panohead", "D"),
                                           ("eg3d", "G"), ("eg3d", "D")])
def test_losses_and_gradients_match_jax(nets, variant, phase):
    n = _get(nets, variant)
    d, key = n["data"], jax.random.PRNGKey(10)
    k_g, k_d = jax.random.split(key)
    step = gan.make_gan_train_step(n["G"], n["D"], n["cfg"])
    real = {k: _t(d[k]) for k in ("image", "image_raw", "image_mask")}
    for do_reg in (True, False):
        with jax.enable_x64(False):
            if phase == "G":
                (jl, jm), jgr = n["g_fn"](n["gp"], n["dp"], k_g, jnp.asarray(d["z"]),
                                          jnp.asarray(d["c"]), jnp.float32(0),
                                          jnp.asarray(do_reg))
                jflat = generator_state_from_params(jgr)
            else:
                (jl, jm), jgr = n["d_fn"](n["dp"], n["gp"], k_d, jnp.asarray(d["z"]),
                                          jnp.asarray(d["c"]),
                                          {k: jnp.asarray(v) for k, v in real.items()},
                                          jnp.asarray(d["c"]), jnp.float32(0),
                                          jnp.asarray(do_reg))
                jflat = flatten_params(jgr)
            draws = gan_step_draws(key)
        net = n["G"] if phase == "G" else n["D"]
        tensors = gan.trained_tensors(net)
        for t in tensors:
            t.requires_grad_(True)
        if phase == "G":
            loss, metrics = step.g_loss(draws.child("g"), _t(d["z"]), _t(d["c"]), 0.0, do_reg)
        else:
            loss, metrics = step.d_loss(draws.child("d"), _t(d["z"]), _t(d["c"]), real,
                                        _t(d["c"]), 0.0, do_reg)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        _check(loss, metrics, grads, list(net.state_dict()), jl, jm, jflat)
        if do_reg:
            reg = "Loss/G/reg" if phase == "G" else "Loss/r1_penalty"
            assert float(metrics[reg]) > 0


def test_step_adam_and_ema(nets):
    """One port step on PanoHead: G's Adam moves each tensor as optax moves
    it on the same gradient (JAX's), D's likewise; the EMA is JAX's lerp;
    the G phase writes no gradient into D and the D phase none into G."""
    n = _get(nets, "panohead")
    G = TriPlaneGenerator.from_config(n["G"].config)
    G.load_state_dict(n["G"].state_dict())
    D = Discriminator.from_config(n["D"].config)
    D.load_state_dict(n["D"].state_dict())
    state = gan.init_gan_state(G, D, TriPlaneGenerator.from_config(G.config), n["cfg"])
    d = n["data"]
    with jax.enable_x64(False):
        (_, _), jgr = n["g_fn"](n["gp"], n["dp"], jax.random.PRNGKey(4), jnp.asarray(d["z"]),
                                jnp.asarray(d["c"]), jnp.float32(0), jnp.asarray(True))
        tx = optax.adam(0.0025 * 4 / 5, b1=0.0 ** 0.8, b2=0.99 ** 0.8, eps=1e-8)
        ref = generator_state_from_params(_jit(
            lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(jgr, n["gp"]))
        jflat = generator_state_from_params(jgr)
    tensors = gan.trained_tensors(G)
    for name, t in zip(G.state_dict(), tensors):
        t.grad = _t(jflat[name]).reshape(t.shape)
    state.g_opt.step()
    for name, t in G.state_dict().items():
        np.testing.assert_allclose(t.numpy(), ref[name].reshape(t.shape), rtol=2.4e-7, atol=1e-7,
                                   err_msg=name)

    real = {k: _t(d[k]) for k in ("image", "image_raw", "image_mask")}
    before = {k: v.clone() for k, v in state.G_ema.state_dict().items()}
    step = gan.make_gan_train_step(G, D, n["cfg"])
    seen = {}

    def timer(name):
        seen[name] = ([t.grad for t in gan.trained_tensors(D)] if name == "D" else None)

    state, metrics = step(state, TorchDraws(torch.Generator().manual_seed(0)), _t(d["z"]),
                          _t(d["c"]), real, _t(d["c"]), stage_timer=timer)
    assert state.step == 1 and state.cur_nimg == B and set(seen) == {"G", "D", "ema"}
    assert all(g is None for g in seen["D"])   # the G phase wrote nothing into D
    assert all(t.grad is None for t in gan.trained_tensors(G))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    with jax.enable_x64(False):
        cur = jnp.float32(B)
        beta = float(0.5 ** (B / jnp.maximum(jnp.minimum(10.0 * 1000.0, cur * 0.05), 1e-8)))
    assert abs(gan.ema_beta(n["cfg"], float(B)) - beta) <= 1e-7
    for k, e in state.G_ema.state_dict().items():
        p = G.state_dict()[k]
        np.testing.assert_allclose(e.numpy(), (p + (before[k] - p) * beta).numpy(), atol=1e-7)
