"""The port's decode-and-render frame end to end vs the JAX package, plus
the port's packaging rules: it imports without jax, CPU tensors never reach
a kernel, a CUDA-side wrapper without its kernel library raises (no
fallback) for every kernel of the frame (K1-K3) and of the train step
(K4-K7), the builders need a card unless asked for the CPU, and the JAX
weight export loads strictly."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.flagship import decode_and_render as jdecode_and_render
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.flagship import flagship_raster_config as jraster_config
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port.torch_export import decoder_state_dict, save_torch_state_dict
from gaussian_gan_decoder_tpu_torch import flagship, kernel_lib
from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads, pallas_heads_vjp
from gaussian_gan_decoder_tpu_torch.decoder.heads import CHAIN, GaussianDecoder
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.port.from_jax import DROPPED_PREFIXES, load_decoder_state
from gaussian_gan_decoder_tpu_torch.splat import pallas_blend

GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, channel_base=512,
              channel_max=32, num_fp16_res=0)
TS, M, BLOCK, IMG, FOV = 32, 1000, 256, 64, 0.227
BG = (0.0, 0.0, 0.0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    jg = JGen(without_sr=True, rendering_kwargs=(("triplane_size", TS),), **GEN_KW)
    jd = JDec(generator=jg, decoder_type="sequential_reversed", int8_sampling=True,
              pallas_heads=True, heads_bf16=True, gelu="poly6", slab_sampling=True,
              pallas_mapping=True)

    def init():
        # the generator sub-trees of TriPlaneGenerator.init, less the 128^2
        # background synthesis (the costliest to trace, and dropped like
        # decoder / torgb / t_mapping on import)
        ks = jax.random.split(jax.random.PRNGKey(1), 4)
        gp = {"backbone": jg.backbone.init(ks[0]), "decoder": jg.decoder.init(ks[1]),
              "torgb": jg.torgb.init(ks[2]), "t_mapping": jg.t_mapping.init(ks[3])}
        return jd.init(jax.random.PRNGKey(0), generator_params=gp)

    params = jax.jit(init)()
    sd = decoder_state_dict(jd, params)
    td = GaussianDecoder(TriPlaneGenerator(rendering_kwargs={"triplane_size": TS},
                                          without_sr=True, **GEN_KW))
    load_decoder_state(td, sd)
    return jd, params, td, sd


def test_decode_and_render_matches_jax(models):
    """latent -> planes -> slab decode -> binning -> blend, weights carried
    across by from_jax; the JAX side runs its Pallas kernels in interpret
    mode with the f32-payload raster config. Image PSNR >= 30 dB, decoded
    attributes within 5e-2 of each attribute's max."""
    jd, params, td, _ = models
    rng = np.random.RandomState(0)
    pos = ((rng.rand(M, 3) - 0.5) * 0.4).astype(np.float32)
    z = rng.randn(1, 32).astype(np.float32)
    cp, c2w = jcam_params()
    cfg = dataclasses.replace(jraster_config(), packed_payloads=False, bf16_colors=False,
                              fused_sort_key=False, rgb10_payloads=False,
                              static_copies=4, overflow_budget=8192)
    jctx = jd.make_slab_context(pos, block=BLOCK)
    jimg, jdec, jaux = jdecode_and_render(
        jd, params, jnp.asarray(z), cp, c2w, jnp.asarray(pos), FOV, image_size=IMG,
        bg=BG, raster_cfg=cfg, backend="pallas", return_aux=True, slab_ctx=jctx)
    assert int(jaux["n_dropped"]) == 0

    launches = (pallas_mapping.mapping_forward.launches,
                pallas_heads.decode_project_slab.launches, pallas_blend.blend_tiles.launches)
    tcp, tc2w = flagship.default_camera_params(device="cpu")
    img, dec, aux = flagship.decode_and_render(
        td, td.fold(), torch.tensor(z), tcp, tc2w, td.make_slab_context(pos, block=BLOCK),
        FOV, image_size=IMG, bg=BG, return_aux=True)
    assert launches == (pallas_mapping.mapping_forward.launches,
                        pallas_heads.decode_project_slab.launches,
                        pallas_blend.blend_tiles.launches)
    img, jimg = img.numpy(), np.asarray(jimg)
    assert img.shape == jimg.shape == (3, IMG, IMG) and np.isfinite(img).all()
    assert jimg.max() > 0.1 and img.std() > 0
    psnr = 10 * np.log10(1.0 / np.mean((img - jimg) ** 2))
    print(f"end-to-end port vs JAX: {psnr:.2f} dB")
    assert psnr >= 30.0, psnr
    for name, ref in jdec.items():
        ref = np.asarray(ref)
        err = np.abs(dec[name].numpy() - ref).max() / np.abs(ref).max()
        print(f"  decoded {name}: {err:.3e}")
        assert err <= 5e-2, (name, err)
    assert aux["n_dropped"] == 0
    agree = (aux["visibility_filter"].numpy() == np.asarray(jaux["visibility_filter"])).mean()
    assert agree >= 0.995, agree


def test_port_imports_without_jax():
    """Every module of the port imports with jax (and the JAX package)
    refused by the import system."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")) or \\
                        name.split(".")[0] == "gaussian_gan_decoder_tpu":
                    raise ImportError(f"refused: {name}")
                return None

        sys.meta_path.insert(0, Refuse())
        import gaussian_gan_decoder_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for n in names:
            importlib.import_module(n)
        assert "jax" not in sys.modules
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


# every kernel wrapper, with the module attribute of its plain version
WRAPPERS = ((pallas_mapping, "mapping_forward", "mapping_forward_plain"),
            (pallas_heads, "decode_project_slab", "decode_project_slab_plain"),
            (pallas_blend, "blend_tiles", "blend_tiles_plain"),
            (pallas_blend, "blend_train", "blend_train_plain"),
            (pallas_blend, "blend_train_bwd", "blend_train_bwd_plain"),
            (pallas_heads, "decode_heads", "decode_heads_plain"),
            (pallas_heads_vjp, "decode_heads_bwd", "decode_heads_bwd_plain"))


def _launches():
    return tuple(getattr(mod, fn).launches for mod, fn, _ in WRAPPERS)


def _wrapper_calls():
    """One call of each kernel wrapper at tiny shapes, on the CPU."""
    gen = TriPlaneGenerator(rendering_kwargs={"triplane_size": TS}, without_sr=True, **GEN_KW)
    dec = GaussianDecoder(gen, rng=torch.Generator().manual_seed(0))
    w = dec.fold()
    ctx = dec.make_slab_context(((np.random.RandomState(1).rand(300, 3) - 0.5) * 0.4)
                                .astype(np.float32), block=BLOCK)
    cam = make_camera(IMG, FOV, flagship.default_camera_params(device="cpu")[1])
    vol = torch.zeros((3, 5, 40, 36 * 32), dtype=torch.int8)
    starts = torch.zeros(17, dtype=torch.int32)
    cw = pallas_heads.pack_chain_f32(dec.heads(), CHAIN, 3, -2.5, "exact")
    stage, out16, img = torch.zeros(64, 128), torch.zeros(64, 16), torch.zeros(16, 256, 4)
    return [
        lambda: pallas_mapping.mapping_forward(torch.zeros(1, 32), torch.zeros(1, 25),
                                               w.mapping),
        lambda: pallas_heads.decode_project_slab(w.chain, vol, torch.ones(3, 32), ctx, cam),
        lambda: pallas_blend.blend_tiles(starts, torch.zeros(9, 0), 4, 4, 16, 640),
        lambda: pallas_blend.blend_train(starts, torch.zeros(9, 0), 4, 4, 16, 1024),
        lambda: pallas_blend.blend_train_bwd(starts, torch.zeros(9, 0), img, img, 4, 4, 16,
                                             1024),
        lambda: pallas_heads.decode_heads(stage, cw),
        lambda: pallas_heads_vjp.decode_heads_bwd(stage, out16, out16, cw),
    ]


def test_cpu_tensors_never_reach_a_kernel(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached a CUDA kernel")

    monkeypatch.setattr(kernel_lib, "library", no_library)
    counts = _launches()
    calls = _wrapper_calls()
    assert len(calls) == len(WRAPPERS)
    for call in calls:
        call()
    assert counts == _launches()


def test_cuda_wrapper_without_library_raises(monkeypatch, tmp_path):
    """Tensors that dispatch to the kernel (device check patched to say
    CUDA) with no buildable library raise; the plain version never runs."""
    calls = _wrapper_calls()

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_called(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kernel_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(kernel_lib, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", tmp_path)
    for mod, _, plain in WRAPPERS:
        monkeypatch.setattr(mod, plain, plain_called)
    kernel_lib.library.cache_clear()
    try:
        for call in calls:
            with pytest.raises(RuntimeError, match="nvcc"):
                call()
    finally:
        kernel_lib.library.cache_clear()


@pytest.mark.parametrize("builder", ["flagship_generator", "flagship_decoder",
                                     "default_camera_params"])
def test_builders_default_to_the_card(builder):
    """Without a card a builder raises unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(flagship, builder)()
    if builder == "default_camera_params":
        cp, c2w = flagship.default_camera_params(device="cpu")
        assert cp.device.type == "cpu" and tuple(cp.shape) == (1, 25)


def test_from_jax_is_strict(models, tmp_path):
    _, _, td, sd = models
    assert any(k.startswith(DROPPED_PREFIXES) for k in sd)
    missing = {k: v for k, v in sd.items() if k != "xyz_decoder.backbone.6.bias"}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_decoder_state(td, missing)
    extra = dict(sd, **{"G.backbone.mapping.fc9.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_decoder_state(td, extra)
    # the .pt route: save_torch_state_dict on the JAX side, a path here
    path = str(tmp_path / "decoder.pt")
    save_torch_state_dict(path, sd)
    load_decoder_state(td, path)
    for k, v in td.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
