"""Port parity of the slab route at f32 (K2-f32's plain version) and of the
decoder options' slab context against the JAX package (the Pallas slab
kernel in interpret mode at compute_dtype f32), on a 32^2 tri-grid of depth
3 and a 32^2 EG3D tri-plane (the bilinear form), 600 template points, slab
block 256, for D-par (parallel heads, the xyz embedding, exact GELU) and a
sequential chain with the "poly" GELU.

Tolerances. The slab context's pack bit for bit and its f32 staging (the
embedded position, init, valid) within 1e-7 (both take the embedding's
bands in float64). The rows: K2's tolerances against the JAX slab kernel
(tests/test_torch_eg3d_decode.py::_k2_tolerances: rows 0:14 within 5e-2 of
each row's max, px/py/depth/opac within 5e-2, visibility agreement >=
0.995): even at f32 the JAX kernel lerps with int8-quantised (z, y)
weights and bf16 products, the port in f32 (the 5e-2 of
tests/test_slab.py:193-200, the JAX slab route against its brick route).
On the tri-grid, the port's slab rows against its own table route on the
same planes (both lerp the same int8 volume in f32, then the f32 chain):
within 1e-4 of each row's scale on the raw head rows. (The EG3D table
route samples a bf16 table, not the slab's int8 volume.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port.torch_export import decoder_state_dict
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_decoder_state
from test_torch_eg3d_decode import _k2_tolerances
from test_torch_slab_decode import head_params
from _torch_threads import torch_threads  # noqa: F401  (autouse)

GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, channel_base=512,
              channel_max=32, num_fp16_res=0)
TS, M, BLOCK, IMG, FOV = 32, 600, 256, 64, 0.227
D_PAR = ("parallel", True, "exact")
D_SEQ = ("sequential", False, "poly")


def _pair(variant, decoder_type, emb, gelu, seed):
    """JAX and port f32 decoders of the options with the same heads."""
    rk = {"triplane_size": TS}
    jd = JDec(generator=JGen(variant=variant, without_sr=True, rendering_kwargs=tuple(rk.items()),
                             **GEN_KW),
              decoder_type=decoder_type, use_xyz_embedding=emb, int8_sampling=True,
              pallas_heads=True, heads_bf16=False, gelu=gelu, slab_sampling=True)
    params = head_params(jd, seed)
    td = GaussianDecoder(TriPlaneGenerator(variant=variant, rendering_kwargs=rk,
                                           without_sr=True, **GEN_KW),
                         gelu=gelu, decoder_type=decoder_type, use_xyz_embedding=emb,
                         heads_bf16=False)
    sd = dict(decoder_state_dict(jd, params))
    sd.update({f"G.{k}": v for k, v in td.G.state_dict().items()})
    load_decoder_state(td, sd)
    return jd, params, td


@pytest.fixture(scope="module")
def frame():
    rng = np.random.RandomState(31)
    pos = ((rng.rand(M, 3) - 0.5) * 0.4).astype(np.float32)
    _, c2w = jcam_params()
    return dict(pos=pos, jcam=jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), c2w),
                cam=make_camera(IMG, FOV, np.asarray(c2w)),
                planes={"panohead": rng.randn(1, 3, 96, TS, TS).astype(np.float32),
                        "eg3d": rng.randn(1, 3, 32, TS, TS).astype(np.float32)})


def test_f32_slab_context_matches_jax(frame):
    """D-par's slab context: the pack and the f32 staging with the embedded
    position (63 columns), init and valid, against the JAX context's."""
    jd, _, td = _pair("panohead", *D_PAR, 40)
    jctx = jd.make_slab_context(frame["pos"], block=BLOCK)
    ctx = td.make_slab_context(frame["pos"], block=BLOCK)
    assert ctx.aux.dtype == torch.float32 and jctx.aux.dtype == jnp.float32
    np.testing.assert_array_equal(ctx.perm, np.asarray(jctx.perm))
    np.testing.assert_array_equal(ctx.valid.numpy(), np.asarray(jctx.valid))
    np.testing.assert_allclose(ctx.aux.numpy(), np.asarray(jctx.aux), rtol=0, atol=1e-7)
    assert ctx.aux[:, 32:95].abs().sum() > 0 and not ctx.aux[:, 95:120].any()


@pytest.mark.parametrize("variant", ["panohead", "eg3d"])
def test_f32_slab_rows_match_jax(frame, variant):
    """GaussianDecoder.decode_project on the slab route at f32 (K2-f32's
    plain version; the bilinear form on the EG3D tri-plane) against the JAX
    decoder's slab kernel at f32, and on the tri-grid against the port's own
    table route."""
    cases = (D_PAR, D_SEQ) if variant == "panohead" else (D_PAR,)
    planes = frame["planes"][variant]
    for k, opts in enumerate(cases):
        jd, params, td = _pair(variant, *opts, 41 + k)
        jctx = jd.make_slab_context(frame["pos"], block=BLOCK)
        jrows, jlayout = jd.decode_project(params, jnp.asarray(planes),
                                           jnp.asarray(frame["pos"]), frame["jcam"],
                                           slab_ctx=jctx)
        ctx = td.make_slab_context(frame["pos"], block=BLOCK)
        w = td.fold()
        assert w.chain.w1.dtype == torch.float32
        rows, layout = td.decode_project(w, torch.tensor(planes), frame["cam"], slab_ctx=ctx)
        assert layout == dict(jlayout)
        rows = rows.numpy()
        _k2_tolerances(rows, np.asarray(jrows), ctx.valid.numpy() > 0,
                       f"K2-f32 plain vs JAX slab at f32 ({variant}, {opts})")
        if variant == "eg3d":
            continue   # its table route samples a bf16 table, not the int8 volume
        table, _ = td.decode_project(w, torch.tensor(planes), frame["cam"],
                                     init_position=torch.tensor(frame["pos"]))
        a, b = table.numpy()[:14, :M], rows[:14][:, ctx.inv_slot.numpy()]
        err = (np.abs(a - b) / np.maximum(np.abs(a).max(axis=1, keepdims=True), 1e-3)).max()
        print(f"  port slab vs port table route at f32: rows 0:14 worst {err:.3e}")
        assert err <= 1e-4
