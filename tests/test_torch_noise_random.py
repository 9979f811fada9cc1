"""Port parity for noise_mode="random" (models/stylegan2.py,
models/superresolution.py, models/triplane.py) against the JAX package,
with JAX's noise keys handed to the port as a name -> key draws object
(tests/_gan_draws.py: the network splits its key one a block, a block one
a conv layer, the SR stack in two). A synthesis layer (f32 and bf16), the
StyleGAN2 synthesis network, the SR stack and a PanoHead generator's
synthesis with superresolution_noise_mode 'random'. The JAX side runs in
float32, x64 off. Tolerance: 1e-5 abs on the f32 layers, block, network
and generator image (noise_strength 0.5, 0.1 in the generator, so the
noise moves every output), 1e-5 of the largest value on the SR stack's
image; the bf16 layer within 1e-2 of its largest value (bf16 rounding of
the same draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.models import stylegan2 as jsg2
from gaussian_gan_decoder_tpu.models import superresolution as jsr
from gaussian_gan_decoder_tpu.models import triplane as jtriplane
from gaussian_gan_decoder_tpu.port import torch_pickle as jpickle
from gaussian_gan_decoder_tpu_torch.models import stylegan2, superresolution
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import RenderDraws
from gaussian_gan_decoder_tpu_torch.utils.draws import TorchDraws
from _gan_draws import block_noise_draws, leaf, node, synthesis_noise_draws
from _jax_fast import jax_fast  # noqa: F401  (autouse)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

SR = "training.superresolution.SuperresolutionHybrid2X"


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _tree(module, value=0.5):
    """Every noise_strength of the port module set to value (in place) ->
    its state dict as the JAX param tree of the same network (names split
    at the dots): the two sides share weights without JAX's eager init."""
    tree = {}
    for k, v in module.state_dict().items():
        if k.endswith("noise_strength"):
            v.fill_(value)
        node = tree
        *parents, leaf_name = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf_name] = v.numpy()
    return tree


def _abs(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max())


def test_layer_random_noise():
    """A synthesis layer (up 2) with JAX's key: f32 within 1e-5 abs, bf16
    within 1e-2 of the largest value; 'const' and 'none' as JAX's; without
    draws 'random' raises."""
    jl = jsg2.SynthesisLayer(in_channels=4, out_channels=6, w_dim=8, resolution=8, up=2)
    tl = stylegan2.SynthesisLayer(4, 6, 8, 8, up=2, generator=torch.Generator().manual_seed(0))
    params = _tree(tl)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 4, 4).astype(np.float32)
    w = rng.randn(2, 8).astype(np.float32)
    key = jax.random.PRNGKey(3)
    run = jax.jit(lambda p, x, w, k: jl.apply(p, x, w, noise_mode="random", noise_key=k))
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, None)):
        ref = run(params, jnp.asarray(x).astype(jdt), jnp.asarray(w), key)
        with torch.no_grad():
            got = tl(_t(x).to(dt), _t(w), noise_mode="random", draws=leaf(key))
        assert got.dtype == dt
        ref = np.asarray(ref.astype(jnp.float32))
        err = _abs(got.float(), ref)
        print(f"layer random {dt}: {err:.3e}")
        assert err <= (tol if tol is not None else 1e-2 * np.abs(ref).max()), (dt, err)
    for mode in ("const", "none"):
        ref = jax.jit(lambda p, x, w: jl.apply(p, x, w, noise_mode=mode))(
            params, jnp.asarray(x), jnp.asarray(w))
        with torch.no_grad():
            assert _abs(tl(_t(x), _t(w), noise_mode=mode), ref) <= 1e-5, mode
    with pytest.raises(ValueError, match="random"), torch.no_grad():
        tl(_t(x), _t(w), noise_mode="random")


def test_block_and_network_random_noise():
    """A synthesis block (conv0 and conv1 on the block's two keys) and the
    StyleGAN2 synthesis network (one key a block) within 1e-5 abs."""
    rng = np.random.RandomState(2)
    jb = jsg2.SynthesisBlock(in_channels=6, out_channels=5, w_dim=8, resolution=8,
                             img_channels=3, is_last=True)
    tb = stylegan2.SynthesisBlock(6, 5, 8, 8, 3, is_last=True,
                                  generator=torch.Generator().manual_seed(4))
    bparams = _tree(tb)
    x = rng.randn(2, 6, 4, 4).astype(np.float32)
    img = rng.randn(2, 3, 4, 4).astype(np.float32)
    ws = rng.randn(2, 3, 8).astype(np.float32)
    key = jax.random.PRNGKey(5)
    rx, rimg = jax.jit(lambda p, x, i, w, k: jb.apply(p, x, i, w, noise_mode="random",
                                                       noise_key=k))(
        bparams, jnp.asarray(x), jnp.asarray(img), jnp.asarray(ws), key)
    with torch.no_grad():
        gx, gimg = tb(_t(x), _t(img), _t(ws), noise_mode="random",
                      draws=block_noise_draws(key, 2))
    for name, got, ref in (("block x", gx, rx), ("block img", gimg, rimg)):
        err = _abs(got, ref)
        print(f"{name}: {err:.3e}")
        assert err <= 1e-5, (name, err)

    jn = jsg2.SynthesisNetwork(w_dim=8, img_resolution=16, img_channels=3, channel_base=64,
                               channel_max=8, num_fp16_res=0)
    tn = stylegan2.SynthesisNetwork(8, 16, 3, channel_base=64, channel_max=8, num_fp16_res=0,
                                    generator=torch.Generator().manual_seed(6))
    nparams = _tree(tn)
    ws = rng.randn(2, tn.num_ws, 8).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda p, w, k: jn.apply(p, w, noise_mode="random", noise_key=k))(
        nparams, jnp.asarray(ws), key)
    with torch.no_grad():
        got = tn(_t(ws), noise_mode="random",
                 draws=synthesis_noise_draws(key, tn.block_resolutions))
    err = _abs(got, ref)
    print(f"synthesis network: {err:.3e}")
    assert err <= 1e-5, err


def test_sr_random_noise():
    """The 2x SR stack (block0 and block1 on the two halves of the key)
    within 1e-5 of its largest value (its image reaches ~7: f32 rounding
    of 128-channel convs)."""
    jstack = jsr.make_superresolution(SR, channels=8, img_resolution=128)
    tstack = superresolution.make_superresolution(SR, channels=8,
                                                  generator=torch.Generator().manual_seed(8))
    params = _tree(tstack)
    rng = np.random.RandomState(3)
    rgb = rng.randn(1, 3, 32, 32).astype(np.float32)
    x = rng.randn(1, 8, 32, 32).astype(np.float32)
    ws = rng.randn(1, 4, 512).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jax.jit(lambda p, r, x, w, k: jstack.apply(p, r, x, w, noise_mode="random",
                                                      noise_key=k))(
        params, jnp.asarray(rgb), jnp.asarray(x), jnp.asarray(ws), key)
    k0, k1 = jax.random.split(key)
    with torch.no_grad():
        got, _ = tstack(_t(rgb), _t(x), _t(ws), noise_mode="random",
                        draws=node(block0=block_noise_draws(k0, 2),
                                   block1=block_noise_draws(k1, 2)))
    err = _abs(got, ref) / float(np.abs(np.asarray(ref)).max())
    print(f"SR stack: {err:.3e} of its largest value")
    assert err <= 1e-5, err


def test_generator_synthesis_random_noise():
    """A PanoHead generator's synthesis (without SR: the stack's noise is
    test_sr_random_noise's) with noise_mode 'random', JAX's noise key fed
    through a name -> key draws object and JAX's renderer draws: image_raw
    within 1e-5 abs; other draws give another image."""
    rk = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4}
    kw = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=32, channel_base=512,
              channel_max=32, without_sr=True)
    jg = jtriplane.TriPlaneGenerator(rendering_kwargs=tuple(rk.items()), **kw)
    tg = TriPlaneGenerator(rendering_kwargs=rk, generator=torch.Generator().manual_seed(10),
                           **kw)
    _tree(tg, 0.1)
    params = jpickle._nest({k: v.numpy() for k, v in tg.state_dict().items()})
    rng = np.random.RandomState(4)
    ws = (rng.randn(1, tg.backbone.num_ws, 32) * 0.5).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 2.7
    c = np.concatenate([pose.reshape(-1), [4.2647, 0, 0.5, 0, 4.2647, 0.5, 0, 0, 1]])[None]
    c = c.astype(np.float32)
    key, nkey, res = jax.random.PRNGKey(11), jax.random.PRNGKey(12), 32
    ref = jax.jit(lambda p, w, c: jg.synthesis(p, w, c, res, noise_mode="random", key=key,
                                                noise_key=nkey))(
        params, jnp.asarray(ws), jnp.asarray(c))
    k_strat, k_imp = jax.random.split(key)
    draws = RenderDraws(_t(jax.random.uniform(k_strat, (1, res * res, 4, 1))),
                        _t(jax.random.uniform(k_imp, (res * res, 4))))
    with torch.no_grad():
        got = tg.synthesis(_t(ws), _t(c), draws, res, noise_mode="random",
                           noise_draws=synthesis_noise_draws(
                               nkey, tg.backbone.synthesis.block_resolutions))
        other = tg.synthesis(_t(ws), _t(c), draws, res, noise_mode="random",
                             noise_draws=TorchDraws(torch.Generator().manual_seed(0)))
    err = _abs(got["image_raw"], ref["image_raw"])
    print(f"generator synthesis image_raw: {err:.3e} (largest "
          f"{float(np.abs(np.asarray(ref['image_raw'])).max()):.3e})")
    assert err <= 1e-5, err
    assert _abs(got["image_raw"], other["image_raw"]) > 1e-4
