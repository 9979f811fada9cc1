"""The port's decode-and-render frame end to end vs the JAX package (slab
route), the brick route's decode_project vs the JAX decoder's, the brick
frame vs the slab frame and the frame stream vs single frames (port only),
plus the port's packaging rules: it imports without jax, CPU tensors never
reach a kernel, a CUDA-side wrapper without its kernel library raises (no
fallback) for every kernel of the frame (K1-K3, K8-K10) and of the train
step (K4-K7), the builders need a card unless asked for the CPU, and the
JAX weight exports (slab and brick decoders) load strictly."""
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
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port.torch_export import decoder_state_dict, save_torch_state_dict
from gaussian_gan_decoder_tpu_torch import flagship, kernel_lib
from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads, pallas_heads_vjp
from gaussian_gan_decoder_tpu_torch.decoder.heads import CHAIN, GaussianDecoder
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_decoder_state
from gaussian_gan_decoder_tpu_torch.splat import pallas_blend
from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig
from _gan_parts import with_gan_parts
from _torch_threads import torch_threads  # noqa: F401  (autouse)

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
        # the generator sub-trees of TriPlaneGenerator.init (the port loads
        # t_mapping and the background synthesis strictly too)
        ks = jax.random.split(jax.random.PRNGKey(1), 4)
        gp = with_gan_parts(jg, {"backbone": jg.backbone.init(ks[0]),
                                 "decoder": jg.decoder.init(ks[1]),
                                 "torgb": jg.torgb.init(ks[2])})
        return jd.init(jax.random.PRNGKey(0), generator_params=gp)

    params = jax.jit(init)()
    sd = decoder_state_dict(jd, params)
    td = GaussianDecoder(TriPlaneGenerator(rendering_kwargs={"triplane_size": TS},
                                          without_sr=True, **GEN_KW),
                         pallas_heads=True, heads_bf16=True)
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
        FOV, image_size=IMG, bg=BG, return_aux=True,
        raster_cfg=RasterizeConfig(tile_capacity=cfg.tile_capacity))
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


def _brick_decoder(td, gelu, fused):
    """A port decoder with td's weights on the brick route."""
    dec = GaussianDecoder(td.G, gelu=gelu, fused_sampling=fused, pallas_heads=True,
                          heads_bf16=True)
    dec.load_state_dict(td.state_dict())
    return dec


@pytest.mark.parametrize("fused", [False, True], ids=["table", "fused"])
def test_brick_decode_project_matches_jax(models, fused):
    """GaussianDecoder.decode_project without a slab context (the int8
    brick table, then the table sample + K8, or the fused inputs + K9)
    against the JAX decoder's on seeded planes: K2's tolerances on rows
    0:14 and px/py/depth/opac, and for the fused route 1e-3 (abs) on every
    row (both decoders' default 'dots' lerp); visibility agreement
    >= 0.995; pad columns not visible."""
    jd, params, td, _ = models
    jdb = dataclasses.replace(jd, pallas_sampling=True, gelu="poly", slab_sampling=False,
                              fused_sampling=fused)
    rng = np.random.RandomState(3)
    planes = rng.randn(1, 3, 96, TS, TS).astype(np.float32)
    pos = ((rng.rand(M, 3) - 0.5) * 0.4).astype(np.float32)
    _, c2w = jcam_params()
    jcam = jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), c2w)
    jrows, jlayout = jdb.decode_project(params, jnp.asarray(planes), jnp.asarray(pos), jcam)
    dec = _brick_decoder(td, "poly", fused)
    cam = make_camera(IMG, FOV, np.asarray(c2w))
    counter = pallas_heads.decode_project_fused if fused else pallas_heads.decode_project
    before = (counter.launches, pallas_expand.brick_table.launches)
    rows, layout = dec.decode_project(dec.fold(), torch.tensor(planes), cam,
                                      init_position=torch.tensor(pos))
    assert (counter.launches, pallas_expand.brick_table.launches) == before
    assert layout == dict(jlayout)
    rows, jrows = rows.numpy(), np.asarray(jrows)
    assert rows.shape == jrows.shape == (pallas_heads.NROWS, 1024)
    a, b = jrows[:14, :M], rows[:14, :M]
    err = np.abs(a - b) / np.maximum(np.abs(a).max(axis=1, keepdims=True), 1e-3)
    print(f"brick decode_project ({'fused' if fused else 'table'}) vs JAX: rows 0:14 "
          f"worst row-relative {err.max():.3e}")
    assert err.max() < 5e-2, err.max(axis=1)
    pr = pallas_heads.PROJ_ROWS
    for k in ("px", "py", "depth", "opac"):
        e = np.abs(jrows[pr[k], :M] - rows[pr[k], :M]).max() / np.abs(jrows[pr[k], :M]).max()
        assert e < 5e-2, (k, e)
    if fused:   # rows 14:16 are unwritten scratch in the JAX kernel
        keep = [r for r in range(pallas_heads.NROWS) if r not in (14, 15)]
        d = np.abs(rows[keep, :M] - jrows[keep, :M]).max()
        print(f"  every row: max |d| {d:.3e}")
        assert dec.fused_lerp == "dots" and d <= 1e-3
    vis, jvis = rows[pr["visible"]] > 0.5, jrows[pr["visible"]] > 0.5
    assert (vis[:M] == jvis[:M]).mean() >= 0.995 and vis[:M].mean() > 0.5
    assert not vis[M:].any()


def test_brick_frame_matches_slab_frame(models):
    """Port only: one latent and template rendered on the brick route and on
    the slab route with the same GELU. Both quantise with the same absmax
    scales and lerp in f32, so they differ by summation order: image PSNR
    >= 30 dB, decoded attributes within 5e-2 of each max, visibility
    agreement >= 0.995 (the slab test's limits)."""
    _, _, td, _ = models
    rng = np.random.RandomState(4)
    pos = ((rng.rand(M, 3) - 0.5) * 0.4).astype(np.float32)
    z = torch.tensor(rng.randn(1, 32).astype(np.float32))
    tcp, tc2w = flagship.default_camera_params(device="cpu")
    w = td.fold()
    kw = dict(image_size=IMG, bg=BG, return_aux=True)
    simg, sdec, saux = flagship.decode_and_render(td, w, z, tcp, tc2w,
                                                  td.make_slab_context(pos, block=BLOCK),
                                                  FOV, **kw)
    bimg, bdec, baux = flagship.decode_and_render(td, w, z, tcp, tc2w, None, FOV,
                                                  init_position=torch.tensor(pos), **kw)
    mse = float(((bimg - simg) ** 2).mean())
    psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
    agree = float((baux["visibility_filter"] == saux["visibility_filter"]).float().mean())
    print(f"brick vs slab frame: {psnr:.2f} dB, visibility agreement {agree:.5f}")
    assert float(simg.std()) > 0 and psnr >= 30.0
    for name, ref in sdec.items():
        err = float((bdec[name] - ref).abs().max() / ref.abs().max())
        print(f"  decoded {name}: {err:.3e}")
        assert bdec[name].shape == ref.shape == (M, ref.shape[1]) and err <= 5e-2, name
    assert agree >= 0.995 and baux["n_dropped"] == 0


def test_stream_matches_single_frames(models):
    """decode_and_render_stream (4 latents, frame_batch 2, brick route)
    against decode_and_render frame by frame. The stream synthesises two
    latents per batch; the CPU convolutions sum a batch of 2 in another
    order than a batch of 1 (planes 4.7e-7 of their max apart), and where a
    plane value sits at an int8 rounding boundary that moves a feature by
    one quantum: 0.99 of the pixels within 1e-5, all within 1e-4 (read:
    >= 0.99715 and <= 3.6e-5)."""
    _, _, td, _ = models
    rng = np.random.RandomState(5)
    pos = torch.tensor(((rng.rand(M, 3) - 0.5) * 0.4).astype(np.float32))
    zs = torch.tensor(rng.randn(4, 1, 32).astype(np.float32))
    tcp, tc2w = flagship.default_camera_params(device="cpu")
    w = td.fold()
    frames = flagship.decode_and_render_stream(td, w, zs, tcp, tc2w, FOV, init_position=pos,
                                               image_size=IMG, bg=BG, frame_batch=2)
    assert tuple(frames.shape) == (4, 3, IMG, IMG)
    for i in range(4):
        img, _ = flagship.decode_and_render(td, w, zs[i], tcp, tc2w, None, FOV, image_size=IMG,
                                            bg=BG, init_position=pos)
        d = (frames[i] - img).abs()
        err, frac = float(d.max()), float((d <= 1e-5).float().mean())
        print(f"stream frame {i}: max |d| {err:.3e}, within 1e-5 on {frac:.5f} of pixels")
        assert err <= 1e-4 and frac >= 0.99 and float(img.std()) > 0


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
            (pallas_heads_vjp, "decode_heads_bwd", "decode_heads_bwd_plain"),
            (pallas_heads, "decode_project", "decode_project_plain"),
            (pallas_heads, "decode_project_fused", "decode_project_fused_plain"),
            (pallas_expand, "brick_table", "brick_table_plain"),
            # the option forms: K3 packed_v3, K9 'dots', K10 select
            (pallas_blend, "blend_tiles", "blend_tiles_plain"),
            (pallas_heads, "decode_project_fused", "decode_project_fused_plain"),
            (pallas_expand, "brick_table_select", "brick_table_select_plain"))


def _launches():
    return tuple(getattr(mod, fn).launches for mod, fn, _ in WRAPPERS)


def _wrapper_calls():
    """One call of each kernel wrapper at tiny shapes, on the CPU."""
    gen = TriPlaneGenerator(rendering_kwargs={"triplane_size": TS}, without_sr=True, **GEN_KW)
    dec = GaussianDecoder(gen, rng=torch.Generator().manual_seed(0), heads_bf16=True)
    w = dec.fold()
    ctx = dec.make_slab_context(((np.random.RandomState(1).rand(300, 3) - 0.5) * 0.4)
                                .astype(np.float32), block=BLOCK)
    cam = make_camera(IMG, FOV, flagship.default_camera_params(device="cpu")[1])
    vol = torch.zeros((3, 5, 40, 36 * 32), dtype=torch.int8)
    starts = torch.zeros(17, dtype=torch.int32)
    cw = pallas_heads.pack_chain_f32(dec.heads(), CHAIN, 3, -2.5, "exact")
    stage, out16, img = torch.zeros(64, 128), torch.zeros(64, 16), torch.zeros(16, 256, 4)
    bstage, brow = torch.zeros((64, 128), dtype=torch.bfloat16), torch.zeros((64, 256),
                                                                            dtype=torch.int8)
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
        lambda: pallas_heads.decode_project(w.chain, bstage, cam, 10),
        lambda: pallas_heads.decode_project_fused(w.chain, bstage, [brow] * 3,
                                                  torch.zeros(24, 64), torch.ones(3, 32), cam,
                                                  10),
        lambda: pallas_expand.build_brick_table(torch.zeros((3, 32, 3, 4, 4),
                                                            dtype=torch.int8)),
        lambda: pallas_blend.blend_tiles(starts, torch.zeros(4, 0), 4, 4, 16, 640,
                                         payload_format="packed_v3"),
        lambda: pallas_heads.decode_project_fused(w.chain, bstage, [brow] * 3,
                                                  torch.zeros(24, 64), torch.ones(3, 32), cam,
                                                  10, lerp="dots"),
        lambda: pallas_expand.build_brick_table(torch.zeros((3, 32, 3, 4, 4),
                                                            dtype=torch.int8), select=True),
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
    assert all(any(k.startswith(p) for k in sd) for p in ("G.t_mapping.", "G.bcg_synthesis."))
    no_t = {k: v for k, v in sd.items() if not k.startswith("G.t_mapping.")}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_decoder_state(td, no_t)
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


def test_from_jax_loads_brick_decoder(models):
    """The JAX brick-route decoder (the JAX flagship_decoder's fields:
    int8 bricks, Pallas build, poly GELU, fused sampling) exports the same
    heads and generator: its state dict loads strictly into the port's
    brick-route decoder."""
    jd, params, td, _ = models
    jdb = dataclasses.replace(jd, pallas_sampling=True, gelu="poly", slab_sampling=False,
                              fused_sampling=True)
    sd = decoder_state_dict(jdb, params)
    dec = flagship.flagship_decoder(gen=TriPlaneGenerator(rendering_kwargs={"triplane_size": TS},
                                                          without_sr=True, **GEN_KW),
                                    device="cpu", fused_sampling=True)
    assert dec.gelu == "poly" and dec.fused_sampling
    load_decoder_state(dec, sd)
    for k, v in dec.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
