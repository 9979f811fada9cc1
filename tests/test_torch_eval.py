"""The port's decoder evaluation (train/eval.py) and render_simple's
backends (splat/rasterize.py).

eval_metrics on one (render, target) pair equals the JAX loss functions
combined as JAX train/eval.py combines them (DSSIM = 1 - ssim), each within
1e-5 of its value (f32 convolutions in another order); run_eval on the
--smoke trainer returns the Metrics10k means, alternates the random-camera
and the near-frontal sampler, and repeats itself from the same seed; the
'pallas' backend (the frame blend K3, forward only) gives the 'pallas_diff'
forward (K4) within 1e-4 (the training rule stops a pixel once T falls
below 1e-4, the frame rule does not), and within 1e-6 on the pixels the
training rule did not stop; 'xla' (the f32 tile rasterizer) renders as the
JAX 'xla' backend does."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.gaussians import cameras as jcameras
from gaussian_gan_decoder_tpu.losses import image as jimage
from gaussian_gan_decoder_tpu.losses.lpips import VGG16LPIPS as JVGG
from gaussian_gan_decoder_tpu.losses.lpips import lpips_loss as jlpips
from gaussian_gan_decoder_tpu.splat.rasterize import render_simple as jrender_simple
from gaussian_gan_decoder_tpu_torch.apps import train_decoder
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.losses import VGG16LPIPS
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_vgg16_lpips_state
from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig, render_simple
from gaussian_gan_decoder_tpu_torch.train import eval as teval
from gaussian_gan_decoder_tpu_torch.train.eval import eval_metrics, run_eval
from test_torch_losses import vgg_state
from _torch_threads import torch_threads  # noqa: F401  (autouse)


def test_eval_metrics_match_jax():
    rng = np.random.RandomState(0)
    image = rng.rand(3, 32, 32).astype(np.float32)
    target = np.clip(image + rng.randn(3, 32, 32).astype(np.float32) * 0.2, 0, 1)
    target = target.astype(np.float32)
    state = vgg_state(2)
    vgg = VGG16LPIPS()
    load_vgg16_lpips_state(vgg, state)
    with jax.enable_x64(False):
        jvgg = JVGG()
        jp = jvgg.load_torch_state_dict(state)
        a, b = jnp.asarray(image), jnp.asarray(target)
        ref = {"L1": jimage.l1_loss(a, b), "L2": jimage.l2_loss(a, b),
               "LPIPS": jlpips(jvgg, jp, b[None], a[None]),
               "DSSIM": 1.0 - jimage.ssim(a, b)[0], "Sobel": jimage.sobel_loss(a, b)[0]}
        ref = {k: float(v) for k, v in ref.items()}
    got = {k: float(v) for k, v in eval_metrics(torch.tensor(image), torch.tensor(target),
                                                 vgg).items()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        print(f"{k}: port {got[k]:.7f} JAX {v:.7f}")
        assert abs(got[k] - v) <= 1e-5 * abs(v), k


class _StandIn(torch.nn.Module):
    """An IR-SE50 stand-in for 16-pixel images (normalised mean colour)."""

    def extract_feats(self, img):
        e = img.mean(dim=(2, 3))
        return e / e.norm(dim=1, keepdim=True)


def test_run_eval_on_the_smoke_trainer():
    run = train_decoder.build(train_decoder.build_argparser().parse_args(
        ["--random_init", "--smoke", "--force_cpu"]))
    assert run_eval(torch.Generator().manual_seed(0), run.decoder, run.gen, run.vgg,
                    eval_steps=0) == {}
    fovs = []
    real = teval.sample_target

    def recording(draws, gen, z, iteration=None, cfg=None, **kw):
        fovs.append((cfg.fov_offset, cfg.fov_offset_scale))
        return real(draws, gen, z, iteration, cfg, **kw)

    kw = dict(cfg=run.cfg, target_cfg=run.tcfg, raster_cfg=run.rcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(teval, "sample_target", recording)
        m = run_eval(torch.Generator().manual_seed(0), run.decoder, run.gen, run.vgg,
                     _StandIn(), eval_steps=2, **kw)
    assert fovs == [(5.0, 12.0), (10.0, 0.0)] * 2
    assert set(m) == {f"Metrics10k/{k}" for k in ("L1", "L2", "LPIPS", "DSSIM", "Sobel", "id")}
    assert all(math.isfinite(v) for v in m.values()) and 0 < m["Metrics10k/id"] <= 1 + 1e-6
    again = run_eval(torch.Generator().manual_seed(0), run.decoder, run.gen, run.vgg,
                     _StandIn(), eval_steps=2, **kw)
    assert again == m
    no_id = run_eval(torch.Generator().manual_seed(0), run.decoder, run.gen, run.vgg,
                     eval_steps=1, **kw)
    assert "Metrics10k/id" not in no_id and len(no_id) == 5


def _gaussians(seed, n=3000):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a.astype(np.float32))  # noqa: E731
    return {"xyz": t((rng.rand(n, 3) - 0.5) * 0.4), "scale": t(rng.randn(n, 3) * 0.3 - 4.5),
            "rotation": t(rng.randn(n, 4)), "opacity": t(rng.randn(n, 1)),
            "color": t(rng.randn(n, 3))}


def _camera(size=64):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.diag([-1.0, 1.0, -1.0])
    c2w[2, 3] = 2.7
    return make_camera(size, 0.227, c2w)


def test_render_simple_pallas_matches_pallas_diff():
    """The frame blend (K3's plain version) and the training blend's
    forward (K4's) on the same 3000 Gaussians at 64^2."""
    decoded = _gaussians(1)
    bg = torch.tensor([0.2, 0.3, 0.4])
    cfg = RasterizeConfig()
    fwd = render_simple(_camera(), decoded, bg, cfg, backend="pallas")
    ref = render_simple(_camera(), decoded, bg, cfg)
    d = (fwd["render"] - ref["render"]).abs()
    live = ref["alpha"][0] < 1 - 1e-4     # pixels the training rule did not stop
    print(f"pallas vs pallas_diff: max |d| {float(d.max()):.3e}, on the {float(live.float().mean()):.3f} "
          f"of pixels not stopped {float(d[:, live].max()):.3e}; {ref['n_pairs']} pairs")
    assert fwd["n_pairs"] == ref["n_pairs"] > 1000 and 0.2 < float(live.float().mean()) < 0.9
    assert float(d.max()) <= 1e-4 and float(d[:, live].max()) <= 1e-6
    assert float(fwd["render"].std()) > 0.01 and fwd["n_dropped"] == 0
    assert torch.equal(fwd["visibility_filter"], ref["visibility_filter"])


@pytest.mark.parametrize("backend", ["xla", "other"])
def test_render_simple_unported_backends(backend):
    """'xla' (the f32 tile rasterizer) renders as JAX render_simple(backend=
    'xla') does on the same camera matrices: the image and alpha within
    rtol 1e-5 and atol 1e-6; an unknown backend raises ValueError."""
    decoded = _gaussians(2, 100)
    if backend != "xla":
        with pytest.raises(ValueError, match="backend"):
            render_simple(_camera(), decoded, torch.zeros(3), backend=backend)
        return
    cam = _camera()
    jcam = jcameras.Camera(*(jnp.asarray(getattr(cam, f).numpy()) for f in (
        "world_view_transform", "full_proj_transform", "camera_center")),
        cam.tanfovx, cam.tanfovy, cam.image_width, cam.image_height)
    bg = torch.tensor([0.1, 0.5, 0.9])
    with jax.enable_x64(False):
        ref = jrender_simple(jcam, {k: jnp.asarray(v.numpy()) for k, v in decoded.items()},
                             jnp.asarray(bg.numpy()), backend="xla")
    out = render_simple(cam, decoded, bg, backend="xla")
    for k in ("render", "alpha"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)
    assert out["n_dropped"] == int(ref["n_dropped"]) == 0 and float(out["alpha"].max()) > 0.1
