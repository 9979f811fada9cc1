"""The distillation step with the decoder's other types and options:

- one step of `--decoder_type parallel --use_pos_encoding` (D-par: parallel
  heads, the 63-column xyz embedding, the f32 kernel chain K6 / K7 in
  their plain versions) against JAX make_loss_fn on the JAX CLI's --smoke
  configuration, as tests/test_torch_train_step.py holds the default
  decoder (same draws, same limits: the loss and every metric within 1e-4,
  every gradient within 2e-3 of its tensor's own largest; the port's LPIPS
  in float64 there, for the reason given in that file). The JAX side runs
  under jax.jit (eagerly the default decoder's step takes ~107 s);
- the plane-reuse guard: with use_gen_finetune off, a 'sequential' step
  re-synthesises its planes through the mapping on the real camera
  (decoder.apply), while the other types reuse the frozen target's planes
  (decoder.decode_from_planes), as JAX's distill step decides;
- the trainer CLI (`--smoke --force_cpu`) with `--decoder_type parallel
  --use_pos_encoding`, `--decoder_type sequential` and `--hidden_dim 64
  --no-pallas_heads_train`: finite losses, and the final snapshot rebuilds
  the same decoder options."""
import copy
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.losses.lpips import VGG16LPIPS as JVGG
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port.torch_export import (
    decoder_state_dict, generator_state_from_params)
from gaussian_gan_decoder_tpu.splat.rasterize import RasterizeConfig as JRCfg
from gaussian_gan_decoder_tpu.train.distill import make_loss_fn as jmake_loss_fn
from gaussian_gan_decoder_tpu_torch.apps import train_decoder
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.snapshot import load_decoder
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetDraws
from gaussian_gan_decoder_tpu_torch.losses import VGG16LPIPS, lpips_loss
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.port.from_jax import (
    load_decoder_state, load_generator_state, load_vgg16_lpips_state)
from gaussian_gan_decoder_tpu_torch.train import distill
from gaussian_gan_decoder_tpu_torch.train.distill import (
    DistillConfig, init_train_state, make_loss_fn)
from test_torch_losses import vgg_state
from test_torch_train_step import BG, GEN_KW, HEADS, IMG, RK, _cfgs, _draws
from _gan_parts import with_gan_parts
from _torch_threads import torch_threads  # noqa: F401  (autouse)


def _generator_params(jg):
    """The JAX smoke generator's params as test_torch_train_step sets them
    (a raised density bias, non-zero noise strengths)."""
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    gp = {"backbone": jg.backbone.init(ks[0]), "decoder": jg.decoder.init(ks[1]),
          "torgb": jg.torgb.init(ks[2])}
    gp["decoder"]["fc1"]["bias"] = gp["decoder"]["fc1"]["bias"].at[0].set(0.3)
    for blk in gp["backbone"]["synthesis"].values():
        for layer in ("conv0", "conv1"):
            if layer in blk:
                blk[layer]["noise_strength"] = jnp.float32(0.1)
    return with_gan_parts(jg, gp)


@pytest.fixture(scope="module")
def setup():
    with jax.enable_x64(False):
        jg = JGen(without_sr=True, rendering_kwargs=tuple(RK.items()), **GEN_KW)
        jd = JDec(generator=jg, decoder_type="parallel", use_xyz_embedding=True,
                  pallas_heads_train=True)
        gparams, params = jax.jit(lambda: (lambda gp: (gp, jd.init(
            jax.random.PRNGKey(1), generator_params=gp)))(_generator_params(jg)))()
    frozen = TriPlaneGenerator(rendering_kwargs=RK, without_sr=True, **GEN_KW)
    load_generator_state(frozen, generator_state_from_params(gparams))
    dec = GaussianDecoder(copy.deepcopy(frozen), gelu="exact", decoder_type="parallel",
                          use_xyz_embedding=True, pallas_heads_train=True)
    load_decoder_state(dec, decoder_state_dict(jd, params))
    vstate = vgg_state(1)
    vgg = VGG16LPIPS()
    load_vgg16_lpips_state(vgg, vstate)
    return jd, gparams, params, JVGG().load_torch_state_dict(vstate), frozen, dec, vgg


@pytest.fixture(scope="module")
def step(setup):
    """JAX's loss, metrics and gradients and the port's, for one D-par step."""
    jd, gparams, params, jvgg_params, frozen, dec, vgg = setup
    jtcfg, tcfg, jdcfg, dcfg = _cfgs()
    z = np.random.RandomState(0).randn(1, 32).astype(np.float32)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(False):
        jfn = jmake_loss_fn(jd, gparams, JVGG(), jvgg_params, None, None, jdcfg, jtcfg, JRCfg())
        (jloss, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
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
             if not name.startswith(("G.decoder.", "G.torgb."))}
    return (float(jloss), {k: float(v) for k, v in jmetrics.items()},
            decoder_state_dict(jd, jgrads), float(loss.detach()),
            {k: float(v) for k, v in metrics.items()}, grads)


@pytest.mark.parametrize("part", ["loss", "heads", "generator"])
def test_parallel_embedding_step_matches_jax(step, part):
    jloss, jmetrics, ref, loss, metrics, grads = step
    if part == "loss":
        print(f"D-par loss port {loss:.6f} JAX {jloss:.6f}")
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
    print(f"D-par {part}: gradients of {n_checked} tensors, worst {worst:.3e} of their own max")
    assert n_checked >= (40 if part == "heads" else 50)
    # the first layers read the 63-column embedding: 32 + 63 inputs each
    if part == "heads":
        assert grads["xyz_decoder.backbone.0.weight"].shape == (128, 95)


def test_sequential_step_does_not_reuse_frozen_planes(setup):
    """use_gen_finetune off, reuse_frozen_planes on: the 'sequential' step
    decodes through decoder.apply (its mapping sees the real camera), the
    other types through decode_from_planes on the target's planes."""
    _, _, _, _, frozen, _, vgg = setup
    _, tcfg, _, _ = _cfgs()
    cfg = DistillConfig(image_size=IMG, bg_color=BG, use_gen_finetune=False,
                        reuse_frozen_planes=True)
    g = torch.Generator().manual_seed(2)
    draws = TargetDraws.make(g, frozen, tcfg, "cpu")
    z = torch.randn(1, 32, generator=g)
    for decoder_type, via_apply in (("sequential", True), ("parallel", False),
                                    ("sequential_reversed", False)):
        dec = GaussianDecoder(copy.deepcopy(frozen), gelu="exact", decoder_type=decoder_type,
                              rng=torch.Generator().manual_seed(3))
        init_train_state(dec, frozen, cfg)
        calls = []
        apply, from_planes = dec.apply, dec.decode_from_planes
        dec.apply = lambda *a, **kw: calls.append("apply") or apply(*a, **kw)
        dec.decode_from_planes = (lambda *a, **kw: calls.append("planes")
                                  or from_planes(*a, **kw))
        loss, _, _ = make_loss_fn(dec, frozen, vgg, cfg, tcfg)(draws, z, 0)
        assert math.isfinite(float(loss.detach()))
        assert calls[0] == ("apply" if via_apply else "planes"), (decoder_type, calls)


def test_trainer_cli_decoder_options(tmp_path):
    for k, flags in enumerate((["--decoder_type", "parallel", "--use_pos_encoding"],
                               ["--decoder_type", "sequential"],
                               ["--hidden_dim", "64", "--no-pallas_heads_train"])):
        out = train_decoder.main(["--random_init", "--smoke", "--force_cpu", "--num_iter", "2",
                                  "--scalars_interval", "1", "--eval_steps", "1",
                                  "--outdir", str(tmp_path / str(k))] + flags)
        with open(os.path.join(out["outdir"], "stats.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        assert "final_eval" in rows.pop()
        assert [r["step"] for r in rows] == [0, 1]
        assert all(math.isfinite(r["Loss/total"]) and r["Loss/total"] > 0 for r in rows)
        dec, _ = load_decoder(os.path.join(out["outdir"], "decoder_final"), device="cpu")
        args = train_decoder.build_argparser().parse_args(flags)
        assert (dec.decoder_type, dec.use_xyz_embedding, dec.hidden_dim,
                dec.pallas_heads_train) == (args.decoder_type, args.use_pos_encoding,
                                            args.hidden_dim, args.pallas_heads_train)
        assert not dec.heads_bf16 and dec.gelu == "exact"
