"""Port parity: StyleGAN2 ops and the tri-grid plane synthesis of
gaussian_gan_decoder_tpu_torch vs the JAX package, f32, on random inputs
made with numpy. Tolerance: max|d| <= 1e-3 * max|ref| in f32; bias_act on
bf16 inputs is exact. Where the synthesis runs bf16 blocks, see
test_synthesis_planes for the bound and the evidence behind it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.ops import bias_act as jbias_act
from gaussian_gan_decoder_tpu.ops import modulated_conv2d as jmodconv
from gaussian_gan_decoder_tpu.ops import setup_filter as jsetup_filter
from gaussian_gan_decoder_tpu.ops import upfirdn2d as jupfirdn2d
from gaussian_gan_decoder_tpu.port.torch_export import generator_state_from_params
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.ops import bias_act, modulated_conv2d, setup_filter, upfirdn2d
from _torch_threads import torch_threads  # noqa: F401  (autouse)

GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, channel_base=512,
              channel_max=32)


def _close(out, ref, what, tol=1e-3):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    print(f"{what} vs JAX: {err:.3e}")
    assert err <= tol, err


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("act,gain,clamp", [("lrelu", None, None), ("lrelu", 0.7, 256.0),
                                            ("linear", None, 0.5)])
def test_bias_act(act, gain, clamp, bf16):
    """bf16 inputs (the synthesis' bf16 blocks) round at the same points as
    the JAX package: slope and gain in x's dtype, so the results are equal."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 5, 5).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    if bf16:
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    ref = jbias_act(jx, jnp.asarray(b), act=act, gain=gain, clamp=clamp)
    out = bias_act(tx, torch.tensor(b), act=act, gain=gain, clamp=clamp)
    assert out.dtype == tx.dtype
    _close(out.float(), np.asarray(ref.astype(jnp.float32)), "bias_act", 0.0 if bf16 else 1e-3)


@pytest.mark.parametrize("up,down,padding", [(2, 1, [2, 1, 2, 1]), (1, 2, 1), (2, 1, 0)])
def test_upfirdn2d(up, down, padding):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 9, 7).astype(np.float32)
    ref = jupfirdn2d(jnp.asarray(x), jsetup_filter([1, 3, 3, 1]), up=up, down=down,
                     padding=padding, gain=up * up)
    out = upfirdn2d(torch.tensor(x), setup_filter([1, 3, 3, 1]), up=up, down=down,
                    padding=padding, gain=up * up)
    _close(out, ref, "upfirdn2d")


@pytest.mark.parametrize("up,demodulate", [(1, True), (2, True), (1, False)])
def test_modulated_conv2d(up, demodulate):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 8, 8).astype(np.float32)
    w = rng.randn(5, 6, 3, 3).astype(np.float32)
    s = rng.randn(2, 6).astype(np.float32)
    noise = rng.randn(8 * up, 8 * up).astype(np.float32) * 0.3
    f = [1, 3, 3, 1]
    ref = jmodconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), noise=jnp.asarray(noise),
                   up=up, padding=1, resample_filter=jsetup_filter(f),
                   demodulate=demodulate, flip_weight=(up == 1))
    out = modulated_conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(s),
                           noise=torch.tensor(noise), up=up, padding=1,
                           resample_filter=setup_filter(f), demodulate=demodulate,
                           flip_weight=(up == 1))
    _close(out, ref, "modulated_conv2d")


@pytest.fixture(scope="module")
def generators(request):
    """(JAX generator, its params, the port's generator with the same
    weights) with num_fp16_res = request.param: the blocks at the top
    num_fp16_res resolutions run in bf16."""
    kw = dict(GEN_KW, num_fp16_res=request.param)
    jg = JGen(without_sr=True, rendering_kwargs=(("triplane_size", 32),), **kw)
    bb = jax.jit(jg.backbone.init)(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    # exercise the const noise path: non-zero noise strengths
    for blk in bb["synthesis"].values():
        for layer in ("conv0", "conv1"):
            if layer in blk:
                blk[layer]["noise_strength"] = jnp.asarray(np.float32(rng.rand() * 0.5))
    params = {"backbone": bb}
    tg = TriPlaneGenerator(rendering_kwargs={"triplane_size": 32}, without_sr=True, **kw)
    tg.backbone.load_state_dict({k.removeprefix("backbone."): torch.tensor(v)
                                 for k, v in generator_state_from_params(params).items()},
                                strict=True)
    return jg, params, tg


def _bf16_ulp(v: float) -> float:
    """One bf16 rounding step (8 significant bits) at magnitude v."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("generators,psi,tol", [(0, 1.0, 1e-3), (0, 0.7, 1e-3),
                                                (2, 1.0, None)],
                         indirect=["generators"], ids=["f32-1.0", "f32-0.7", "bf16-1.0"])
def test_synthesis_planes(generators, psi, tol):
    """mapping -> tri-grid planes (N, 3, 32*D, H, W), noise_mode='const';
    all blocks in f32 (max|d| <= tol * max|ref|), or the 16^2 and 32^2
    blocks in bf16 as the flagship runs its top 4 resolutions.

    bf16: every op of the port rounds where the JAX package rounds. Fed the
    same inputs, bias_act, upfirdn2d, the modulated convs and the ToRGB
    layers give results equal to JAX's, except where a bf16 convolution's
    f32 sum, taken in another order by torch's CPU convolution than by
    XLA's, lies within 1e-7 of a bf16 rounding boundary: that output
    element then rounds one bf16 step the other way (about 1e-4 of the
    elements, on any CPU). The step carries on into the skip image. So:
      * 99% of the plane elements agree within 1e-5 of max|ref| (measured
        ~8e-8; a misplaced rounding point, such as the f32 lrelu slope
        once fixed in ops/bias_act.py, puts 84% of them past 1e-5);
      * no element is further than 1.25 bf16 steps at the 0.9999 quantile
        of the bf16 ToRGB outputs' magnitudes: a flip is one step of the
        output it hits, the skip image's upsampling filter only shrinks
        it, and the margin covers an element that two flips reach. Here
        that quantile is in [4, 8), a step of 2.3e-3 of max|ref|, so the
        bound is 2.9e-3; measured 2.3e-3. Only 3 of the 368,640 outputs
        lie above 8, where a flip would read twice that. Running the
        blocks in bf16 at all moves the planes by 7.8e-3 of max|ref|.
    """
    from gaussian_gan_decoder_tpu_torch.models.stylegan2 import ToRGBLayer

    jg, params, tg = generators
    rng = np.random.RandomState(4)
    z = rng.randn(1, 32).astype(np.float32)
    c = rng.randn(1, 25).astype(np.float32)
    jws = jg.mapping(params, jnp.asarray(z), jnp.asarray(c), truncation_psi=psi)
    ref = jg.synthesis_planes(params, jws, noise_mode="const")
    rgb = []

    def bf16_rgb(_mod, _inp, y):
        if y.dtype == torch.bfloat16:
            rgb.append(y.float().abs().flatten().numpy())

    hooks = [m.register_forward_hook(bf16_rgb) for m in tg.modules()
             if isinstance(m, ToRGBLayer)]
    with torch.no_grad():
        ws = tg.mapping(torch.tensor(z), torch.tensor(c), truncation_psi=psi)
        out = tg.synthesis_planes(ws, noise_mode="const")
    for h in hooks:
        h.remove()
    assert tuple(out.shape) == (1, 3, 96, 32, 32)
    _close(ws, jws, "ws")
    if tol is not None:
        _close(out, ref, "synthesis_planes", tol)
        return
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    d = np.abs(out.numpy().astype(np.float64) - ref) / scale
    q99, worst = float(np.quantile(d, 0.99)), float(d.max())
    assert rgb, "no bf16 ToRGB output seen"
    bound = 1.25 * _bf16_ulp(float(np.quantile(np.concatenate(rgb), 0.9999))) / scale
    print(f"synthesis_planes vs JAX: q99 {q99:.3e}, max {worst:.3e} (bound {bound:.3e})")
    assert q99 <= 1e-5, q99
    assert worst <= bound, (worst, bound)
