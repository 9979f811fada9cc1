"""The port's distillation step vs the JAX package's make_loss_fn /
make_train_step, on the JAX CLI's --smoke configuration (z/w 32, 16^2
tri-grid of depth 3, 4 + 4 depth samples, no SR, a 32^2 image, 1024
surface points from a 16^3 sigma grid, random VGG16), with the JAX draws
rebuilt from its key splits. The JAX side runs in float32 (x64 off, as its
CLI runs) with its Pallas kernels in interpret mode; the port on the CPU
takes the kernels' plain versions. One JAX value_and_grad and one port
step (module-scoped) serve the three cases of the comparison.

Tolerances: the loss and every metric within 1e-4 (relative); the gradient
of every trainable tensor within 2e-3 of that tensor's own largest
gradient (the f32 chain through synthesis, sampling, the head chain,
projection and blend is summed in another order on each side). Then one
Adam update from identical gradients: parameters within 1e-3 of the
learning rate plus one f32 spacing of the parameter.

The port's LPIPS term runs in float64 here (its own lpips_loss on a double
copy of the same VGG; the distance comes back as f32); its float32 form is
held against JAX's alone in test_torch_losses.test_lpips_matches_jax.
Evidence (this step, this CPU): the port run wholly in float64 agrees with
JAX's float32 gradients to <= 5e-5 of every tensor's own max, so the two
compute the same step. With the port's LPIPS in float32 its xyz and
rotation head tensors are up to 6.4e-3 of their own max from JAX's: those
heads' gradients are 2.8e-5 to 2.0e-3 of the largest head gradient,
near-cancelling sums over the points, and they magnify the 7.6e-6 (of its
max) f32 gap between the two VGG backward passes on this near-flat 32^2
render. With the LPIPS term in float64 the worst gaps are 1.3e-4 (heads)
and 8.4e-5 (generator) of each tensor's own max, so 2e-3 holds with no
floor; a head tensor scaled by 0.5 reads 0.5 and fails."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.decoder.target_pipeline import TargetSamplerConfig as JTCfg
from gaussian_gan_decoder_tpu.losses.lpips import VGG16LPIPS as JVGG
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port.torch_export import (
    decoder_state_dict, flatten_params, generator_state_from_params)
from gaussian_gan_decoder_tpu.splat.rasterize import RasterizeConfig as JRCfg
from gaussian_gan_decoder_tpu.train.distill import DistillConfig as JDCfg
from gaussian_gan_decoder_tpu.train.distill import make_loss_fn as jmake_loss_fn
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import (
    TargetDraws, TargetSamplerConfig)
from gaussian_gan_decoder_tpu_torch.losses import VGG16LPIPS, lpips_loss
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import RenderDraws
from gaussian_gan_decoder_tpu_torch.port.from_jax import (
    load_decoder_state, load_generator_state, load_vgg16_lpips_state)
from gaussian_gan_decoder_tpu_torch.train import distill
from gaussian_gan_decoder_tpu_torch.train.distill import (
    DistillConfig, init_train_state, make_loss_fn, make_train_step)

from test_torch_losses import vgg_state
from _gan_parts import with_gan_parts
from _torch_threads import torch_threads  # noqa: F401  (autouse)

RK = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4,
      "c_gen_conditioning_zero": True}
GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=32, channel_base=512,
              channel_max=32)
IMG, POINTS, RES, LEVEL = 32, 1024, 16, 0.5
BG = (0.55717, 0.52256, 0.51045)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _cfgs():
    common = dict(camera_sampling="normal", init_truncation=1.0, truncation_ramp=20_000,
                  vertical_stddev=0.3, horizontal_stddev=1.0, shape_res=RES,
                  num_points=POINTS, mc_level=LEVEL, face_capacity=12 * (RES - 1) ** 3,
                  neural_rendering_resolution=IMG)
    return (JTCfg(sigma_separable=True, **common), TargetSamplerConfig(**common),
            JDCfg(image_size=IMG, bg_color=BG, raster_backend="pallas_diff"),
            DistillConfig(image_size=IMG, bg_color=BG))


@pytest.fixture(scope="module")
def setup():
    with jax.enable_x64(False):
        jg = JGen(without_sr=True, rendering_kwargs=tuple(RK.items()), **GEN_KW)
        jd = JDec(generator=jg, pallas_heads_train=True)

        def init():
            ks = jax.random.split(jax.random.PRNGKey(0), 3)
            gp = {"backbone": jg.backbone.init(ks[0]), "decoder": jg.decoder.init(ks[1]),
                  "torgb": jg.torgb.init(ks[2])}
            gp["decoder"]["fc1"]["bias"] = gp["decoder"]["fc1"]["bias"].at[0].set(0.3)
            # non-zero noise strengths: their gradient is compared too
            for blk in gp["backbone"]["synthesis"].values():
                for layer in ("conv0", "conv1"):
                    if layer in blk:
                        blk[layer]["noise_strength"] = jnp.float32(0.1)
            gp = with_gan_parts(jg, gp)
            return gp, jd.init(jax.random.PRNGKey(1), generator_params=gp)

        gparams, params = jax.jit(init)()
    frozen = TriPlaneGenerator(rendering_kwargs=RK, without_sr=True, **GEN_KW)
    load_generator_state(frozen, generator_state_from_params(gparams))
    dec = GaussianDecoder(copy.deepcopy(frozen), gelu="exact", pallas_heads_train=True)
    load_decoder_state(dec, decoder_state_dict(jd, params))
    vstate = vgg_state(1)
    vgg = VGG16LPIPS()
    load_vgg16_lpips_state(vgg, vstate)
    return jd, gparams, params, JVGG().load_torch_state_dict(vstate), frozen, dec, vgg


def _draws(key):
    """The JAX step's draws (make_loss_fn splits the step key, then
    sample_target splits its half; jax.random's f32 default)."""
    k_target, _ = jax.random.split(key)
    k_fov, k_cam, k_render, k_surf = jax.random.split(k_target, 4)
    kh, kv = jax.random.split(k_cam)
    k_strat, k_imp = jax.random.split(k_render)
    kf, kw, ks = jax.random.split(k_surf, 3)
    u = jax.random.uniform
    return TargetDraws(
        fov_u=_t(u(k_fov, ())), cam_h=_t(jax.random.normal(kh, (1, 1))),
        cam_v=_t(jax.random.normal(kv, (1, 1))),
        render=RenderDraws(_t(u(k_strat, (1, IMG * IMG, 4, 1))), _t(u(k_imp, (IMG * IMG, 4)))),
        face_u=_t(u(kf, (POINTS,))), weight_u=_t(u(kw, (POINTS, 3))),
        thickness_n=_t(jax.random.normal(ks, (POINTS,))))


def _grads_by_name(jgrads):
    """JAX gradient tree -> reference-named flat dict (the export names)."""
    return {k: np.asarray(v) for k, v in flatten_params(jgrads).items()}


HEADS = ("color_decoder.", "opacity_decoder.", "rotation_decoder.", "scale_decoder.",
         "xyz_decoder.")


@pytest.fixture(scope="module")
def step(setup):
    """JAX's loss, metrics and gradients and the port's, for one step."""
    jd, gparams, params, jvgg_params, frozen, dec, vgg = setup
    jtcfg, tcfg, jdcfg, dcfg = _cfgs()
    z = np.random.RandomState(0).randn(1, 32).astype(np.float32)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(False):
        jfn = jmake_loss_fn(jd, gparams, JVGG(), jvgg_params, None, None, jdcfg, jtcfg, JRCfg())
        (jloss, (jmetrics, _)), jgrads = jax.value_and_grad(jfn, has_aux=True)(
            params, key, jnp.asarray(z), 0)
        draws = _draws(key)
    dec = copy.deepcopy(dec)
    vgg64 = copy.deepcopy(vgg).double()

    def lpips64(_, target, image, dtype=None):
        return lpips_loss(vgg64, target.double(), image.double()).float()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distill, "lpips_loss", lpips64)
        loss, metrics, _ = make_loss_fn(dec, frozen, vgg, dcfg, tcfg)(draws, torch.tensor(z), 0)
        loss.backward()
    grads = {name: (np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy())
             for name, p in dec.named_parameters()
             # G.decoder / G.torgb are not on the decode path: zero on both sides
             if not name.startswith(("G.decoder.", "G.torgb."))}
    return (float(jloss), {k: float(v) for k, v in jmetrics.items()},
            decoder_state_dict(jd, jgrads), float(loss.detach()),
            {k: float(v) for k, v in metrics.items()}, grads)


@pytest.mark.parametrize("part", ["loss", "heads", "generator"])
def test_train_step_matches_jax(step, part):
    jloss, jmetrics, ref, loss, metrics, grads = step
    if part == "loss":
        print(f"loss port {loss:.6f} JAX {jloss:.6f}")
        assert int(jmetrics["General/n_dropped"]) == 0
        assert abs(loss - jloss) <= 1e-4 * abs(jloss)
        for k, v in jmetrics.items():
            if k.startswith("Loss/"):
                assert abs(metrics[k] - v) <= 1e-4 * max(abs(v), 1e-3), k
        assert int(metrics["General/n_pairs"]) > 0
        return
    names = [n for n in grads if n.startswith(HEADS) == (part == "heads")]
    worst, n_checked = 0.0, 0
    for name in names:
        g, r = grads[name], ref[name]
        own = np.abs(r).max()
        err = np.abs(g - r).max() / max(own, 1e-12)
        if own > 0:
            n_checked += 1
            worst = max(worst, err)
        assert err <= 2e-3, (name, err, own)
    print(f"{part}: gradients of {n_checked} tensors, worst {worst:.3e} of their own max")
    assert n_checked >= (40 if part == "heads" else 50)


def test_adam_update_matches_optax(setup):
    """One Adam step (lr 9e-5, betas 0.9/0.999, eps 1e-8) from identical
    gradients, torch.optim.Adam vs optax.adam."""
    _, _, _, _, frozen, dec, _ = setup
    dec = copy.deepcopy(dec)
    state = init_train_state(dec, copy.deepcopy(frozen), DistillConfig())
    rng = np.random.RandomState(1)
    params = {n: p.detach().numpy().copy() for n, p in dec.named_parameters()}
    grads = {n: np.asarray(rng.randn(*p.shape) * 10.0 ** rng.uniform(-6, 0), np.float32)
             for n, p in params.items()}
    for n, p in dec.named_parameters():
        p.grad = torch.tensor(grads[n])
    state.optimizer.step()
    tx = optax.adam(9e-5, b1=0.9, b2=0.999, eps=1e-8)
    with jax.enable_x64(False):
        jp = {n: jnp.asarray(v) for n, v in params.items()}
        new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
            {n: jnp.asarray(g) for n, g in grads.items()}, jp)
    for n, p in dec.named_parameters():
        # the step is ~lr; old + step rounds to the parameter's own f32 grid,
        # so the two may differ by one spacing of that grid
        ref = np.asarray(new[n])
        tol = 1e-3 * 9e-5 + np.spacing(np.abs(params[n]).astype(np.float32))
        assert np.all(np.abs(p.detach().numpy() - ref) <= tol), n


def test_train_step_takes_steps(setup):
    """make_train_step on the CPU: three steps, finite losses, heads and the
    G copy change, the frozen generator does not."""
    _, _, _, _, frozen, dec, vgg = setup
    frozen, dec = copy.deepcopy(frozen), copy.deepcopy(dec)
    _, tcfg, _, dcfg = _cfgs()
    state = init_train_state(dec, frozen, dcfg)
    step = make_train_step(dec, frozen, vgg, dcfg, tcfg)
    before = {n: p.detach().clone() for n, p in dec.named_parameters()}
    fz = {n: p.detach().clone() for n, p in frozen.named_parameters()}
    g = torch.Generator().manual_seed(0)
    for i in range(3):
        state, metrics, aux = step(state, TargetDraws.make(g, frozen, tcfg, "cpu"),
                                   torch.randn(1, 32, generator=g), i)
        assert np.isfinite(float(metrics["Loss/total"]))
    assert state.step == 3
    moved = {n for n, p in dec.named_parameters() if not torch.equal(p, before[n])}
    assert any(n.startswith("color_decoder.") for n in moved)
    assert any(n.startswith("G.backbone.synthesis.") for n in moved)
    assert all(torch.equal(p, fz[n]) for n, p in frozen.named_parameters())
