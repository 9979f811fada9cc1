"""Port parity for StyleGAN3 (models/stylegan3.py, ops/filtered_lrelu.py)
and the equivariance metrics (metrics/equivariance.py) against the JAX
package: the Kaiser filter design (bit for bit: the same scipy calls),
filtered_lrelu on separable and radial filters (1e-5 of the largest
value), a small Generator3 carried across from JAX's init
(port/from_jax.load_param_tree; image within 1e-4 abs) with a user
transform, the integer, fractional and rotation image operators (1e-5 of
the largest value) and compute_equivariance_metrics on the same key
(PSNRs within 1e-3 dB). The JAX side runs in float32, x64 off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.metrics import equivariance as jeq
from gaussian_gan_decoder_tpu.models import stylegan3 as jsg3
from gaussian_gan_decoder_tpu.ops.filtered_lrelu import filtered_lrelu as jfiltered_lrelu
from gaussian_gan_decoder_tpu_torch.metrics import equivariance
from gaussian_gan_decoder_tpu_torch.models import stylegan3
from gaussian_gan_decoder_tpu_torch.ops import filtered_lrelu
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_param_tree
from _jax_fast import jax_fast  # noqa: F401  (autouse)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

SYN = dict(channel_base=256, channel_max=16, num_layers=4, num_critical=1, margin_size=2)
G3 = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=32, img_channels=3)


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.fixture(scope="module")
def g3():
    """(JAX Generator3, its init params, the port's with them loaded)."""
    with jax.enable_x64(False):
        jg = jsg3.Generator3(**G3, synthesis_kwargs=tuple(SYN.items()))
        params = jax.jit(jg.init)(jax.random.PRNGKey(0))
    tg = stylegan3.Generator3(**G3, synthesis_kwargs=SYN)
    load_param_tree(tg, jax.tree.map(np.asarray, params))
    return jg, params, tg


def test_filter_design_and_filtered_lrelu():
    """design_lowpass_filter bit for bit (separable and radial, and None for
    one tap); filtered_lrelu (bias, up 2 / down 2, asymmetric padding,
    clamp) on both filter kinds within 1e-5 of the largest value."""
    for args in ((12, 4.0, 4.0, 32.0, False), (12, 4.0, 4.0, 32.0, True), (6, 2.0, 3.0, 16.0,
                                                                            False)):
        want = jsg3.design_lowpass_filter(*args[:4], radial=args[4])
        got = stylegan3.design_lowpass_filter(*args[:4], radial=args[4])
        assert np.array_equal(got, want), args
    assert stylegan3.design_lowpass_filter(1, 1.0, 1.0, 2.0) is None
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 9, 9).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    fu = jsg3.design_lowpass_filter(12, 4.0, 4.0, 32.0)
    for fd in (jsg3.design_lowpass_filter(12, 4.0, 4.0, 32.0),
               jsg3.design_lowpass_filter(12, 4.0, 4.0, 32.0, radial=True)):
        kw = dict(up=2, down=2, padding=[7, 6, 7, 6], clamp=1.5)
        ref = jax.jit(lambda x, b: jfiltered_lrelu(x, fu, fd, b, **kw))(jnp.asarray(x),
                                                                          jnp.asarray(b))
        got = filtered_lrelu(_t(x), _t(fu), _t(fd), _t(b), **kw)
        err = _rel(got, ref)
        print(f"filtered_lrelu ({fd.ndim}-D down filter): {err:.3e}")
        assert err <= 1e-5, err


def test_generator3_image_matches_jax(g3):
    """A Generator3 (4 layers, 32^2) from JAX's init: the image within 1e-4
    abs, with and without a user transform on the synthesis input."""
    jg, params, tg = g3
    z = np.random.RandomState(1).randn(2, 16).astype(np.float32)
    ref = jax.jit(lambda p, z: jg.apply(p, z, None, truncation_psi=0.8))(params, jnp.asarray(z))
    with torch.no_grad():
        got = tg(_t(z), None, truncation_psi=0.8)
    err = float(np.abs(got.numpy() - np.asarray(ref)).max())
    print(f"Generator3 image: {err:.3e} (largest {float(np.abs(np.asarray(ref)).max()):.3e})")
    assert got.shape == (2, 3, 32, 32) and err <= 1e-4, err
    m = equivariance.rotation_matrix(0.3)
    m[:2, 2] = (0.05, -0.1)
    sp = {**params["synthesis"], "input": {**params["synthesis"]["input"],
                                           "transform": jnp.asarray(m)}}
    ws = jg.mapping.apply(params["mapping"], jnp.asarray(z), None)
    ref = jax.jit(jg.synthesis.apply)(sp, ws)
    with torch.no_grad():
        got = tg.synthesis(_t(ws), _t(m))
    err = float(np.abs(got.numpy() - np.asarray(ref)).max())
    print(f"Generator3 image, user transform: {err:.3e}")
    assert err <= 1e-4, err


def test_equivariance_operators_match_jax():
    """Integer and fractional translation (image and mask), the rotation's
    resampling and the pseudo-rotation's band limit within 1e-5 of the
    largest value, on images of the generator's shape (JAX runs the
    operators eagerly: test_equivariance_metrics_match_jax then reuses
    their compiled programs)."""
    x = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    cases = [("int", lambda m, x: m.apply_integer_translation(x, 0.125, -0.0833)),
             ("frac", lambda m, x: m.apply_fractional_translation(x, 0.071, -0.113)),
             ("rot", lambda m, x: m.apply_fractional_rotation(x, 0.7)),
             ("pseudo", lambda m, x: m.apply_fractional_pseudo_rotation(x, -1.1))]
    for name, fn in cases:
        ref = fn(jeq, jnp.asarray(x))
        got = fn(equivariance, _t(x))
        for part, g, r in zip(("image", "mask"), got, ref):
            err = _rel(g, r)
            print(f"{name} {part}: {err:.3e}")
            assert err <= 1e-5, (name, part, err)


def test_equivariance_metrics_match_jax(g3):
    """compute_equivariance_metrics (int, frac, rot) on the same key and
    generator: each PSNR within 1e-3 dB."""
    jg, params, tg = g3
    key = jax.random.PRNGKey(3)
    flags = dict(compute_eqt_int=True, compute_eqt_frac=True, compute_eqr=True)
    ref = jeq.compute_equivariance_metrics(jg, params, key, num_samples=2, batch_size=2, **flags)
    got = equivariance.compute_equivariance_metrics(tg, np.asarray(key), num_samples=2,
                                                    batch_size=2, **flags)
    print(f"PSNR (int, frac, rot): port {got}, JAX {ref}")
    assert np.all(np.isfinite(got)) and np.abs(np.subtract(got, ref)).max() <= 1e-3
