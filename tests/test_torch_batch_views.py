"""The port's batched-view step (parallel/distill.py::make_parallel_train_step)
and bf16 LPIPS against the JAX package's, on the CPU.

The batched step: B = 2 views on the JAX CLI's --smoke configuration (as
tests/test_torch_train_step.py builds it), each view with its own latent
and its own draws (JAX's, rebuilt from each view's key), against JAX
make_parallel_train_step on a one-device CPU mesh. Both sides render with
the f32 tile rasterizer (raster_backend 'xla') and train the plain head
chain, so that the JAX step holds no Pallas kernel in interpret mode (the
kernels' plain versions are held in their own files). At the one-view
tolerances: the loss and every metric within 1e-4 (relative); the mean
gradient, read from Adam's first moment (0.1 g after one update), within
2e-3 of each tensor's own largest; the updated parameters, every element
within 2 lr plus one f32 spacing of JAX's, and within 1e-3 lr plus one
spacing where its gradient is at least 1e-2 of its tensor's largest and
1e3 eps (a first Adam update is lr g / (|g| + eps): the sign of a
near-zero gradient is rounding, and a gradient near eps moves the update
by its own relative error). The port's LPIPS term runs in float64 there, for the reason
given in tests/test_torch_train_step.py.

bf16 LPIPS: lpips_loss(dtype=bfloat16) on the same weights and images as
JAX lpips_loss(dtype=jnp.bfloat16), the distance within 3 * 2^-8 of JAX's
bf16 distance (relative), and each bf16 distance within 2^-5 of its own
float32 one: every feature is rounded to bf16's 8 bits in 13 layers."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.losses.lpips import VGG16LPIPS as JVGG
from gaussian_gan_decoder_tpu.losses.lpips import lpips_loss as jlpips
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.parallel import make_mesh, make_parallel_train_step as jparallel
from gaussian_gan_decoder_tpu.port.torch_export import (
    decoder_state_dict, generator_state_from_params)
from gaussian_gan_decoder_tpu.splat.rasterize import RasterizeConfig as JRCfg
from gaussian_gan_decoder_tpu.train.distill import init_train_state as jinit_state
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.losses import VGG16LPIPS, lpips_loss
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.parallel import make_parallel_train_step
from gaussian_gan_decoder_tpu_torch.port.from_jax import (
    load_decoder_state, load_generator_state, load_vgg16_lpips_state)
from gaussian_gan_decoder_tpu_torch.train import distill
from gaussian_gan_decoder_tpu_torch.train.distill import init_train_state
from test_torch_decoder_train import _generator_params
from test_torch_losses import _images, vgg_state
from test_torch_train_step import GEN_KW, RK, _cfgs, _draws
from _torch_threads import torch_threads  # noqa: F401  (autouse)

B, LR, EPS = 2, 9e-5, 1e-8


@pytest.fixture(scope="module")
def batched():
    """One batched step on each side -> (JAX metrics, JAX new params, JAX
    first moments, port metrics, port decoder, port first moments, JAX
    gradient scale per name); both from the same weights."""
    jtcfg, tcfg, jdcfg, dcfg = _cfgs()
    jdcfg = jdcfg.__class__(**{**jdcfg.__dict__, "raster_backend": "xla"})
    dcfg = dcfg.__class__(**{**dcfg.__dict__, "raster_backend": "xla"})
    zs = np.random.RandomState(6).randn(B, 1, 32).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    vstate = vgg_state(1)
    with jax.enable_x64(False):
        jg = JGen(without_sr=True, rendering_kwargs=tuple(RK.items()), **GEN_KW)
        jd = JDec(generator=jg, pallas_heads_train=False)
        gparams = jax.jit(lambda: _generator_params(jg))()
        state = jax.jit(lambda gp: jinit_state(jax.random.PRNGKey(1), jd, gp, jdcfg))(gparams)
        before = decoder_state_dict(jd, state.params)
        jvgg = JVGG()
        jstep = jparallel(make_mesh(1, ("data",)), jd, gparams, jvgg,
                          jvgg.load_torch_state_dict(vstate), cfg=jdcfg, target_cfg=jtcfg,
                          raster_cfg=JRCfg())
        state, jmetrics = jstep(state, keys, jnp.asarray(zs), jnp.asarray(0))
        mu = state.opt_state[0].mu
        jnew, jmu = decoder_state_dict(jd, state.params), decoder_state_dict(jd, mu)
        draws = [_draws(k) for k in keys]

    frozen = TriPlaneGenerator(rendering_kwargs=RK, without_sr=True, **GEN_KW)
    load_generator_state(frozen, generator_state_from_params(gparams))
    dec = GaussianDecoder(copy.deepcopy(frozen), gelu="exact", pallas_heads_train=False)
    load_decoder_state(dec, before)
    vgg = VGG16LPIPS()
    load_vgg16_lpips_state(vgg, vstate)
    vgg64 = copy.deepcopy(vgg).double()

    def lpips64(_, target, image, dtype=None):
        return lpips_loss(vgg64, target.double(), image.double()).float()

    pstate = init_train_state(dec, frozen, dcfg)
    # the port's G copy: init_train_state copies the frozen weights, as JAX's does
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distill, "lpips_loss", lpips64)
        step = make_parallel_train_step(dec, frozen, vgg, dcfg, tcfg)
        pstate, metrics, _ = step(pstate, draws, torch.tensor(zs), 0)
    opt = pstate.optimizer
    pmu = {n: opt.state[p]["exp_avg"].numpy() if p in opt.state else np.zeros(p.shape)
           for n, p in dec.named_parameters()}
    assert pstate.step == 1 and int(state.step) == 1
    return ({k: float(v) for k, v in jmetrics.items()}, jnew, jmu,
            {k: float(v) for k, v in metrics.items()}, dec, pmu, before)


@pytest.mark.parametrize("part", ["loss", "moments", "parameters"])
def test_batched_step_matches_jax(batched, part):
    jmetrics, jnew, jmu, metrics, dec, pmu, before = batched
    if part == "loss":
        print(f"B={B} loss port {metrics['Loss/total']:.6f} JAX {jmetrics['Loss/total']:.6f}")
        for k, v in jmetrics.items():
            if k.startswith("Loss/"):
                assert abs(metrics[k] - v) <= 1e-4 * max(abs(v), 1e-3), k
        assert metrics["General/n_dropped"] == jmetrics["General/n_dropped"] == 0
        return
    worst, n_checked = 0.0, 0
    for name, p in dec.named_parameters():
        ref, own = np.asarray(jmu[name]), np.abs(np.asarray(jmu[name])).max()
        if part == "moments":
            err = np.abs(pmu[name] - ref).max() / max(own, 1e-30)
            assert err <= 2e-3, (name, err, own)
        else:
            old = np.asarray(before[name])
            spacing = np.spacing(np.abs(old).astype(np.float32))
            d = np.abs(p.detach().numpy() - np.asarray(jnew[name]))
            assert np.all(d <= 2 * LR + spacing), name
            # gradients (10 mu) well above their tensor's rounding and Adam's eps
            sure = (np.abs(ref) >= 1e-2 * own) & (10 * np.abs(ref) >= 1e3 * EPS)
            err = float((d - spacing)[sure].max(initial=0.0)) / LR
            assert err <= 1e-3, (name, err)
        if own > 0:
            n_checked += 1
            worst = max(worst, err)
    print(f"{part}: {n_checked} tensors with a gradient, worst {worst:.3e}"
          + (" of their own max" if part == "moments" else " lr"))
    assert n_checked >= 90


def test_lpips_bf16_matches_jax():
    state = vgg_state()
    jvgg = JVGG()
    jparams = jvgg.load_torch_state_dict(state)
    vgg = VGG16LPIPS()
    load_vgg16_lpips_state(vgg, state)
    a, b = _images(5, 32)
    with jax.enable_x64(False):
        jf32, jbf16 = np.asarray(jax.jit(lambda p, t, i: jnp.stack(
            [jlpips(jvgg, p, t, i, dtype=dt) for dt in (None, jnp.bfloat16)]))(
            jparams, jnp.asarray(b)[None], jnp.asarray(a)[None])).tolist()
    with torch.backends.mkldnn.flags(enabled=False):
        ta, tb = torch.tensor(a[None], requires_grad=True), torch.tensor(b[None])
        bf16 = lpips_loss(vgg, tb, ta, dtype=torch.bfloat16)
        bf16.backward()
        f32 = float(lpips_loss(vgg, tb, ta.detach()))
    print(f"lpips bf16 port {float(bf16):.6f} JAX {jbf16:.6f}; f32 port {f32:.6f} JAX {jf32:.6f}")
    assert bf16.dtype == torch.float32 and ta.grad.dtype == torch.float32
    assert abs(float(bf16) - jbf16) <= 3 * 2 ** -8 * abs(jbf16)
    assert abs(float(bf16) - f32) <= 2 ** -5 * f32 and abs(jbf16 - jf32) <= 2 ** -5 * jf32
    assert float(ta.grad.abs().max()) > 0
