"""The port's IR-SE50 ID loss (losses/id_loss.py) vs the JAX package's, and
the distillation step's ID term (train/distill.py).

The IR-SE50 weights are made in numpy from a seed under the names of the
reference's model_ir_se50.pth and loaded into JAX with
IRSE50.load_torch_state_dict and into the port strictly, with each
unit's residual branch (its second convolution) scaled by 0.3: with plain
He-normal convolutions and random BatchNorm statistics the random network
is chaotic, and f32 rounding alone moves its unit embedding by 4.4e-2 (the
port in f32 against itself in f64; in f64 the port and JAX agree to 5e-11
on those weights), while at 0.3 f32 and f64 agree to 1.5e-7. JAX runs in
float32 (x64 off). Tolerances: embeddings within 2e-5 (absolute, unit
vectors), id_loss within 2e-5, its gradient with respect to the image
within 1e-3 of the gradient's largest magnitude at 256 px (read 6.7e-6),
3e-3 at 512 px (read 1.4e-3): there JAX's own f32 gradient is the far one,
4.1e-3 from the float64 gradient on random-pixel images, on which the port
in float64 and JAX in float64 agree to 6.3e-8 and the port in f32 is
7.4e-4 away.

The step's ID term is held on the smoke configuration with the IR-SE50
replaced by a stand-in (the ID crop needs a 223-pixel image): it counts on
frontal draws only, and the host-side gate equals the JAX step's formula
on many draws."""
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.losses import IRSE50 as JIRSE50
from gaussian_gan_decoder_tpu.losses import id_loss as jid_loss
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import (
    TargetDraws, TargetSamplerConfig)
from gaussian_gan_decoder_tpu_torch.losses import IRSE50, id_loss, id_similarity, load_irse50_state
from gaussian_gan_decoder_tpu_torch.train import distill
from gaussian_gan_decoder_tpu_torch.train.distill import (
    DistillConfig, frontal_view, init_train_state, make_train_step)
from _torch_threads import torch_threads  # noqa: F401  (autouse)


def irse_state(seed=0):
    """Seeded random weights under model_ir_se50.pth's names (every name the
    port's module holds), as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in IRSE50().state_dict().items():
        shape = tuple(t.shape)
        if len(shape) == 4:        # convolutions, He-normal
            v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
            if "res_layer.3." in name:
                v = v * 0.3
        elif name.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) == 2:
            v = rng.randn(*shape) * 0.01
        elif name.endswith("running_mean") or name.endswith("bias"):
            v = rng.randn(*shape) * 0.1
        elif name == "input_layer.2.weight" or name.endswith("res_layer.2.weight"):
            v = 0.25 + 0.05 * rng.randn(*shape)          # PReLU slopes
        else:
            v = 1.0 + 0.1 * rng.randn(*shape)            # BatchNorm scales
        out[name] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def nets():
    state = irse_state(0)
    model = IRSE50()
    load_irse50_state(model, state)
    with jax.enable_x64(False):
        jparams = JIRSE50().load_torch_state_dict(state)
    return state, model, jparams


def _images(seed, hw):
    """Two independent random images of 8x8-pixel blocks (the 512-pixel
    case keeps its contrast through the 2x area pooling)."""
    rng = np.random.RandomState(seed)
    a, b = (np.kron(rng.rand(1, 3, hw // 8, hw // 8), np.ones((8, 8))).astype(np.float32)
            for _ in range(2))
    return a, b


@pytest.mark.parametrize("hw", [256, 512], ids=["256px", "512px_area_pooled"])
def test_irse50_and_id_loss_match_jax(nets, hw):
    """Embeddings of both images, id_loss, and d id_loss / d image."""
    _, model, jparams = nets
    a, b = _images(hw, hw)
    jm = JIRSE50()
    with jax.enable_x64(False):
        @jax.jit
        def jrun(x, y):
            loss, grad = jax.value_and_grad(lambda x: jid_loss(jm, jparams, x, y))(x)
            return loss, grad, jm.extract_feats(jparams, x), jm.extract_feats(jparams, y)
        jloss, jgrad, jex, jey = (np.asarray(v) for v in jrun(jnp.asarray(a), jnp.asarray(b)))
    x = torch.tensor(a, requires_grad=True)
    loss = id_loss(model, x, torch.tensor(b))
    loss.backward()
    with torch.no_grad():
        ex, ey = model.extract_feats(x), model.extract_feats(torch.tensor(b))
        sim = id_similarity(model, x, torch.tensor(b))
    e_err = max(np.abs(ex.numpy() - jex).max(), np.abs(ey.numpy() - jey).max())
    g_err = np.abs(x.grad.numpy() - jgrad).max() / np.abs(jgrad).max()
    print(f"{hw}px: embeddings max |d| {e_err:.3e}; id_loss port {loss.item():.6f} JAX "
          f"{float(jloss):.6f}; gradient {g_err:.3e} of its max")
    assert ex.shape == (1, 512) and abs(float(ex.norm()) - 1) < 1e-5
    assert e_err <= 2e-5
    assert abs(float(loss) - float(jloss)) <= 2e-5
    assert abs(float(1 - sim[0]) - float(loss)) <= 1e-6
    assert np.abs(jgrad).max() > 0 and g_err <= (1e-3 if hw == 256 else 3e-3)


def test_irse50_loads_reference_names_strictly(nets):
    """The dict JAX's load_torch_state_dict reads loads strictly; the
    num_batches_tracked entries of a real checkpoint are dropped; a missing
    or an unknown name raises."""
    state, _, _ = nets
    model = IRSE50()
    load_irse50_state(model, dict(state, **{"input_layer.1.num_batches_tracked": np.zeros(())}))
    assert all(torch.equal(model.state_dict()[k], torch.tensor(v)) for k, v in state.items())
    with pytest.raises(RuntimeError):
        load_irse50_state(model, {k: v for k, v in state.items() if k != "body.3.res_layer.1.weight"})
    with pytest.raises(RuntimeError):
        load_irse50_state(model, dict(state, extra=np.zeros(1, np.float32)))


def _jax_frontal(fov_u, h_draw, v_draw, tcfg, cfg):
    """The JAX step's gate (train/distill.py: cam_h, cam_v and fov_deg as
    sample_camera_params makes them), in float32."""
    with jax.enable_x64(False):
        hs, vs = jnp.pi * tcfg.horizontal_stddev, jnp.pi * tcfg.vertical_stddev
        h = jnp.float32(h_draw) * hs + jnp.pi / 2
        v = jnp.float32(v_draw) * vs + jnp.pi / 2
        fov = jnp.float32(fov_u) * tcfg.fov_offset_scale + tcfg.fov_offset
        return bool((jnp.abs(h - jnp.pi / 2) < cfg.id_cam_threshold)
                    & (jnp.abs(v - jnp.pi / 2) < cfg.id_cam_threshold)
                    & (fov > cfg.id_min_fov))


class _StandIn(torch.nn.Module):
    """An IR-SE50 stand-in for 16-pixel images: the embedding is the
    normalised mean colour, so the ID term is 1 - cos of mean colours."""

    def extract_feats(self, img):
        e = img.mean(dim=(2, 3))
        return e / e.norm(dim=1, keepdim=True)


def test_id_term_counts_on_frontal_draws_only():
    """The host-side gate agrees with the JAX step's formula on 400 draws;
    then two smoke steps: a frontal draw adds id_loss_weight x the ID term
    to the total, a non-frontal one adds nothing and runs no IR-SE50."""
    from gaussian_gan_decoder_tpu_torch.apps import train_decoder
    tcfg = TargetSamplerConfig(camera_sampling="normal", vertical_stddev=0.3,
                               horizontal_stddev=1.0)
    cfg = DistillConfig()
    rng = np.random.RandomState(0)
    n_frontal = 0
    for _ in range(400):
        fov_u, h, v = float(rng.rand()), float(rng.randn() * 0.3), float(rng.randn() * 0.8)
        d = TargetDraws(*(torch.zeros(()),) * 6, None, host_camera=(fov_u, h, v))
        got = frontal_view(d, cfg, tcfg)
        assert got == _jax_frontal(fov_u, h, v, tcfg, cfg), (fov_u, h, v)
        n_frontal += got
    assert 20 < n_frontal < 380

    run = train_decoder.build(train_decoder.build_argparser().parse_args(
        ["--random_init", "--smoke", "--force_cpu"]))
    calls = []

    def counted_id_loss(model, image, target):
        calls.append(image.shape)
        return id_loss(model, image, target)

    cfg = DistillConfig(image_size=16, bg_color=run.cfg.bg_color, id_loss_weight=0.7)
    gen = torch.Generator().manual_seed(3)
    frontal = nonfrontal = None
    while frontal is None or nonfrontal is None:
        d = TargetDraws.make(gen, run.gen, run.tcfg, "cpu")
        if frontal_view(d, cfg, run.tcfg):
            frontal = frontal or d
        else:
            nonfrontal = nonfrontal or d
    z = torch.randn((1, run.gen.z_dim), generator=gen)
    losses = {}
    for name, d in (("frontal", frontal), ("nonfrontal", nonfrontal)):
        for irse in (None, _StandIn()):
            dec, frozen = copy.deepcopy(run.decoder), copy.deepcopy(run.gen)
            state = init_train_state(dec, frozen, cfg)
            step = make_train_step(dec, frozen, run.vgg, cfg, run.tcfg, irse=irse)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(distill, "id_loss", counted_id_loss)
                _, m, aux = step(state, d, z, 0)
            losses[name, irse is not None] = (float(m["Loss/total"]), float(m["Loss/id"]), aux)
    total, lid, aux = losses["frontal", True]
    base = losses["frontal", False][0]
    ref = float(1 - (_StandIn().extract_feats(aux["image"][None])
                     * _StandIn().extract_feats(aux["target"][None])).sum())
    print(f"frontal: total {total:.6f} = {base:.6f} + 0.7 x {lid:.6f}; calls {len(calls)}")
    assert len(calls) == 1 and lid > 0 and abs(lid - ref) <= 1e-6
    assert abs(total - (base + 0.7 * lid)) <= 1e-6 * total
    assert losses["nonfrontal", True][1] == 0.0
    assert losses["nonfrontal", True][0] == losses["nonfrontal", False][0]
    assert math.isfinite(total)
