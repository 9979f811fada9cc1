"""The port's discriminator and the ops of the GAN path against the JAX
package: Discriminator in 'dual' (EG3D) and 'mask_dual' (PanoHead) modes,
f32 and with bf16 blocks, on JAX's weights loaded strictly
(port/from_jax.load_discriminator_state); minibatch_std;
filtered_resizing's four filter modes; grid_sample_2d / 3d, values and
gradients; filter2d and downsample2d.

Tolerances: f32 logits within 2e-6 of JAX's scale (max |logit|); with
bf16 blocks 2e-2 (bf16 rounding of activations inside the blocks, whose
products the two packages' CPU convs sum in different orders); the ops
within 1e-6 absolute on unit-scale inputs, gradients within 1e-5."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.models import discriminator as jdisc
from gaussian_gan_decoder_tpu.port.torch_export import flatten_params
from gaussian_gan_decoder_tpu_torch.models import discriminator as tdisc
from gaussian_gan_decoder_tpu_torch.ops import (downsample2d, filter2d, grid_sample_2d,
                                               grid_sample_3d, setup_filter)
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_discriminator_state
from _torch_threads import torch_threads  # noqa: F401  (autouse)

# the JAX ops package exports functions under its modules' names
jgs = importlib.import_module("gaussian_gan_decoder_tpu.ops.grid_sample")
jup = importlib.import_module("gaussian_gan_decoder_tpu.ops.upfirdn2d")


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("mode,fp16", [("dual", 0), ("mask_dual", 0), ("mask_dual", 2)])
def test_discriminator_matches_jax(mode, fp16):
    """A 32² D (16² raw, 16² seg branch, mbstd group 2, cmap from c) on JAX's
    init weights: the same logits; fp16 2 runs b32 and b16 (and sb16) in
    bf16, with the conv clamp at 256."""
    kw = dict(c_dim=25, img_resolution=32, img_channels=3, mode=mode, channel_base=512,
              channel_max=32, num_fp16_res=fp16, conv_clamp=256.0 if fp16 else None,
              seg_resolution=16, mbstd_group_size=2)
    jd = jdisc.Discriminator(**kw)
    params = jax.jit(jd.init)(jax.random.PRNGKey(3))
    td = tdisc.Discriminator(**kw)
    load_discriminator_state(td, flatten_params(params))
    assert tdisc.Discriminator.from_config(td.config).state_dict().keys() == \
        td.state_dict().keys()
    rng = np.random.RandomState(1)
    img = {"image": rng.randn(4, 3, 32, 32), "image_raw": rng.randn(4, 3, 16, 16),
           "image_mask": rng.rand(4, 1, 32, 32)}
    img = {k: v.astype(np.float32) for k, v in img.items()}
    c = rng.randn(4, 25).astype(np.float32)
    ref = np.asarray(jd.apply(params, {k: jnp.asarray(v) for k, v in img.items()},
                              jnp.asarray(c)))
    with torch.no_grad():
        got = td({k: _t(v) for k, v in img.items()}, _t(c)).numpy()
    assert got.shape == ref.shape == (4, 1)
    tol = 2e-2 if fp16 else 2e-6
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), (got, ref)


def test_gan_ops_match_jax():
    """minibatch_std; filtered_resizing in 'antialiased', 'classic', 'none'
    and a float blend; grid_sample_2d / 3d with taps outside the input
    (zeros padding) and their input and grid gradients; filter2d and
    downsample2d with the [1, 3, 3, 1] filter and a separable 9-tap one."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6, 12, 12).astype(np.float32)
    np.testing.assert_allclose(tdisc.minibatch_std(_t(x), 2).numpy(),
                               np.asarray(jdisc.minibatch_std(jnp.asarray(x), 2)), atol=1e-6)
    f = setup_filter([1, 3, 3, 1])
    for mode in ("antialiased", "classic", "none", 0.3):
        ref = np.asarray(jdisc.filtered_resizing(jnp.asarray(x), 5, mode, f.numpy()))
        got = tdisc.filtered_resizing(_t(x), 5, mode, f).numpy()
        assert got.shape == ref.shape == (4, 6, 5, 5)
        np.testing.assert_allclose(got, ref, atol=1e-6)

    for down_f in (f, setup_filter([0.1, 0.2, -0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9])):
        jf = down_f.numpy()
        np.testing.assert_allclose(filter2d(_t(x), down_f).numpy(),
                                   np.asarray(jup.filter2d(jnp.asarray(x), jf)), atol=1e-6)
        np.testing.assert_allclose(
            downsample2d(_t(x), down_f, padding=1).numpy(),
            np.asarray(jup.downsample2d(jnp.asarray(x), jf, padding=1)), atol=1e-6)

    img = rng.randn(2, 3, 7, 9).astype(np.float32)
    grid = (rng.rand(2, 5, 4, 2) * 2.4 - 1.2).astype(np.float32)
    vol = rng.randn(2, 3, 5, 6, 7).astype(np.float32)
    grid3 = (rng.rand(2, 3, 4, 5, 3) * 2.4 - 1.2).astype(np.float32)
    for fn, jfn, inp, g in ((grid_sample_2d, jgs.grid_sample_2d, img, grid),
                            (grid_sample_3d, jgs.grid_sample_3d, vol, grid3)):
        cot = rng.randn(*((inp.shape[0], inp.shape[1]) + g.shape[1:-1])).astype(np.float32)
        ref, vjp = jax.vjp(jfn, jnp.asarray(inp), jnp.asarray(g))
        ti, tg = _t(inp).requires_grad_(True), _t(g).requires_grad_(True)
        got = fn(ti, tg)
        gi, gg = torch.autograd.grad(got, [ti, tg], _t(cot))
        ri, rg = vjp(jnp.asarray(cot))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-6)
        np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=1e-5)
        np.testing.assert_allclose(gg.numpy(), np.asarray(rg), atol=1e-5)
