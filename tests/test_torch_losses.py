"""Port parity for the distillation losses vs the JAX package: L1, L2,
SSIM, Sobel, the area downsample and VGG16-LPIPS, values and gradients.
The VGG16 weights are made in numpy under torchvision's names and loaded
into JAX with VGG16LPIPS.load_torch_state_dict and into the port strictly.
Tolerances: values and gradients within 1e-5 of their max (f32 convs in
another summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.losses import image as jimage
from gaussian_gan_decoder_tpu.losses.lpips import VGG16LPIPS as JVGG, lpips_loss as jlpips
from gaussian_gan_decoder_tpu_torch.losses import (
    VGG16LPIPS, area_downsample, l1_loss, l2_loss, lpips_loss, sobel_loss, ssim)
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_vgg16_lpips_state


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def vgg_state(seed=0):
    """Random VGG16 weights under torchvision's `features.{idx}` names."""
    rng = np.random.RandomState(seed)
    state, idx, cin = {}, 0, 3
    for cout, pool in [(64, False), (64, False), (128, True), (128, False), (256, True),
                       (256, False), (256, False), (512, True), (512, False), (512, False),
                       (512, True), (512, False), (512, False)]:
        if pool:
            idx += 1
        state[f"features.{idx}.weight"] = (rng.randn(cout, cin, 3, 3)
                                           * np.sqrt(2.0 / (cin * 9))).astype(np.float32)
        state[f"features.{idx}.bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
        idx += 2
        cin = cout
    return state


def _images(seed, hw=48):
    rng = np.random.RandomState(seed)
    a = rng.rand(3, hw, hw).astype(np.float32)
    b = np.clip(a + rng.randn(3, hw, hw).astype(np.float32) * 0.2, 0, 1)
    return a, b


@pytest.mark.parametrize("name", ["l1", "l2", "ssim", "sobel"])
def test_image_losses_match_jax(name):
    """Each loss and its gradient w.r.t. the rendered image."""
    jfn = {"l1": jimage.l1_loss, "l2": jimage.l2_loss,
           "ssim": lambda a, b: jimage.ssim(a, b)[0],
           "sobel": lambda a, b: jimage.sobel_loss(a, b)[0]}[name]
    tfn = {"l1": l1_loss, "l2": l2_loss, "ssim": lambda a, b: ssim(a, b)[0],
           "sobel": lambda a, b: sobel_loss(a, b)[0]}[name]
    a, b = _images(1)
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tv = tfn(ta, torch.tensor(b))
    tv.backward()
    assert abs(float(tv) - float(jv)) <= 1e-5 * max(abs(float(jv)), 1e-6)
    assert _rel(ta.grad.numpy(), jg) <= 1e-5


def test_area_downsample_matches_jax():
    x = np.random.RandomState(2).rand(1, 3, 512, 512).astype(np.float32)
    assert _rel(area_downsample(torch.tensor(x), 256), jimage.area_downsample(jnp.asarray(x),
                                                                             256)) <= 1e-6


def test_lpips_matches_jax():
    """VGG16-LPIPS distance and its gradient w.r.t. the rendered image, with
    the same numpy weights loaded into both."""
    state = vgg_state()
    jvgg = JVGG()
    jparams = jvgg.load_torch_state_dict(state)
    vgg = VGG16LPIPS()
    load_vgg16_lpips_state(vgg, state)
    a, b = _images(3, 64)
    jv, jg = jax.value_and_grad(lambda i: jlpips(jvgg, jparams, jnp.asarray(b)[None], i))(
        jnp.asarray(a)[None])
    ta = torch.tensor(a[None], requires_grad=True)
    tv = lpips_loss(vgg, torch.tensor(b[None]), ta)
    tv.backward()
    print(f"lpips {float(tv):.6f} vs JAX {float(jv):.6f}")
    assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv))
    assert _rel(ta.grad.numpy(), jg) <= 1e-5


def test_vgg_loader_is_strict():
    state = vgg_state()
    vgg = VGG16LPIPS()
    with pytest.raises(RuntimeError, match="Missing key"):
        load_vgg16_lpips_state(vgg, {k: v for k, v in state.items() if k != "features.0.bias"})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_vgg16_lpips_state(vgg, dict(state, **{"features.99.weight": np.zeros(1)}))
