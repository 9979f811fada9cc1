"""Port parity for PTI inversion (train/inversion.py, apps/invert.py)
against the JAX package, on the invert app's --smoke generator (z / w 32,
no SR, 16^2 planes, 4 + 4 depth samples; the port's seeded weights, the
same on both sides) and a seeded random VGG16: the learning-rate schedule
(1e-6 relative), compute_w_stats on JAX's draws (the port's numpy
threefry; w_avg and w_std within 1e-5 relative), 3 project steps and 2
project_pti steps with JAX's step keys handed over as a draws object (the
folded camera, the PTI losses and the fine-tuned weights within 1e-4
relative, w within 1e-3: see the test), and `invert --smoke --force_cpu`
writing its two outputs. The JAX side runs in float32, x64 off, each
loop compiled once under jax.jit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.losses import VGG16LPIPS as JVGG
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port import torch_pickle as jpickle
from gaussian_gan_decoder_tpu.train import inversion as jinv
from gaussian_gan_decoder_tpu_torch.apps import invert
from gaussian_gan_decoder_tpu_torch.apps.gen_videos_proj import load_finetuned
from gaussian_gan_decoder_tpu_torch.train import checkpoint, inversion
from _gan_draws import leaf, node, seq
from _jax_fast import jax_fast  # noqa: F401  (autouse)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

NRR = 16


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.fixture(scope="module")
def smoke():
    """(JAX generator, its params, JAX VGG, its params, the port's
    generator, the port's VGG): the port's seeded weights on both sides."""
    tg = invert.smoke_generator(303, "cpu")
    vgg = invert.make_vgg("", "cpu")
    jg = JGen(z_dim=32, c_dim=25, w_dim=32, img_resolution=32, variant="panohead",
              without_sr=True, channel_base=512, channel_max=32,
              rendering_kwargs=tuple(invert.SMOKE_RK.items()))
    gp = jpickle._nest({k: v.numpy() for k, v in tg.state_dict().items()})
    jv = JVGG()
    vp = jv.load_torch_state_dict({k: v.numpy() for k, v in vgg.state_dict().items()})
    return jg, gp, jv, vp, tg, vgg


def _target():
    return np.random.RandomState(0).rand(3, NRR, NRR).astype(np.float32) * 255


def test_lr_schedule_and_w_stats(smoke):
    """_lr_schedule over a run within 1e-6 relative; compute_w_stats of the
    same key (the port draws JAX's z in numpy) within 1e-5 relative."""
    cfg = inversion.ProjectConfig(num_steps=40)
    jcfg = jinv.ProjectConfig(num_steps=40)
    for step in range(40):
        want = float(jinv._lr_schedule(step, jcfg))
        assert abs(inversion._lr_schedule(step, cfg) - want) <= 1e-6 * max(abs(want), 1e-12)
    jg, gp, _, _, tg, _ = smoke
    key = jax.random.PRNGKey(5)
    ref_avg, ref_std = jinv.compute_w_stats(jg, gp, key, 1000)
    avg, std = inversion.compute_w_stats(tg, np.asarray(key), 1000)
    for name, got, ref in (("w_avg", avg, ref_avg), ("w_std", std, ref_std)):
        err = _rel(got, ref)
        print(f"{name}: {err:.3e}")
        assert err <= 1e-5, (name, err)


def test_project_and_pti_match_jax(smoke):
    """3 project steps and 2 project_pti steps with JAX's step keys as a
    draws object: the camera with t_mapping folded in, the PTI losses and
    every fine-tuned tensor within 1e-4 relative, w within 1e-3."""
    jg, gp, jv, vp, tg, vgg = smoke
    cfg = inversion.ProjectConfig(num_steps=3, pti_steps=2, w_avg_samples=500,
                                  neural_rendering_resolution=NRR)
    jcfg = jinv.ProjectConfig(num_steps=3, pti_steps=2, w_avg_samples=500,
                              neural_rendering_resolution=NRR)
    target = _target()
    c = invert.frontal_label().numpy()
    key, pkey = jax.random.PRNGKey(303), jax.random.PRNGKey(304)
    w_ref, c_ref = jax.jit(lambda gp, t, c, vp, k: jinv.project(jg, gp, t, c, jv, vp, k, jcfg))(
        gp, jnp.asarray(target), jnp.asarray(c), vp, key)
    p_ref, l_ref = jax.jit(
        lambda gp, w, t, c, vp, k: jinv.project_pti(jg, gp, w, t, c, jv, vp, k, jcfg))(
        gp, w_ref, jnp.asarray(target), c_ref, vp, pkey)
    _, k_loop = jax.random.split(key)
    steps = {f"step{i}": node(w=leaf(k), render=seq(k, 2))
             for i, k in ((i, jax.random.fold_in(k_loop, i)) for i in range(3))}
    w, c_adj, losses = inversion.project(tg, torch.tensor(target), torch.tensor(c), vgg,
                                         np.asarray(key), cfg, draws=node(**steps))
    assert len(losses) == 3 and all(np.isfinite(losses))
    # optax.adam(1.0) on lr-scaled gradients moves each component by about
    # its gradient's sign: where a component's gradients nearly cancel over
    # the steps, f32 rounding of the gradient moves it by ~1e-4 of w's
    # largest value (1.2e-4 here after 3 steps, 2e-6 after 2), so w is held
    # at 1e-3, the camera at 1e-4
    for name, got, ref, tol in (("w", w, w_ref, 1e-3), ("c", c_adj, c_ref, 1e-4)):
        err = _rel(got, ref)
        print(f"project {name}: {err:.3e}")
        assert err <= tol, (name, err)
    pti = {f"step{i}": node(render=seq(jax.random.fold_in(pkey, i), 2)) for i in range(2)}
    pl = inversion.project_pti(tg, torch.tensor(np.asarray(w_ref)), torch.tensor(target),
                               torch.tensor(np.asarray(c_ref)), vgg, np.asarray(pkey), cfg,
                               draws=node(**pti))
    err = _rel(pl, l_ref)
    print(f"project_pti losses {pl} vs {np.asarray(l_ref)}: {err:.3e}")
    assert err <= 1e-4, err
    flat = jax.tree_util.tree_flatten_with_path(p_ref)[0]
    ref = {".".join(str(getattr(k, "key", k)) for k in path): v for path, v in flat}
    own = tg.state_dict()
    renames = {"decoder.fc0": "decoder.net.0", "decoder.fc1": "decoder.net.2"}
    worst = 0.0
    for name, v in ref.items():
        for a, b in renames.items():
            name = name.replace(a, b)
        worst = max(worst, _rel(own[name], v))
    print(f"project_pti weights: {worst:.3e}")
    assert worst <= 1e-4, worst


def test_invert_smoke_writes_outputs(tmp_path):
    """invert --smoke --force_cpu (2 + 2 steps) writes projected_w.npz and
    a fine-tuned generator that loads back strictly with its config."""
    from PIL import Image
    path = tmp_path / "t.png"
    Image.fromarray(np.random.RandomState(1).randint(0, 255, (40, 40, 3), np.uint8)).save(path)
    out = invert.main(["--smoke", "--force_cpu", "--target", str(path), "--num_steps", "2",
                       "--num_steps_pti", "2", "--outdir", str(tmp_path / "o")])
    w = np.load(tmp_path / "o" / "projected_w.npz")["w"]
    gen = load_finetuned(out["generator_path"], "cpu")
    assert w.shape == (1, gen.num_ws, 32) and np.isfinite(w).all()
    assert len(out["pti_losses"]) == 2 and np.isfinite(out["pti_losses"]).all()
    saved = checkpoint.restore(out["generator_path"])
    assert all(torch.equal(v, saved[k]) for k, v in gen.state_dict().items())
