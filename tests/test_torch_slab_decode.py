"""Port parity of the slab decode route: int8 slab volume, host pack and
the fused decode's plain version (kernel K2's CPU path) of
gaussian_gan_decoder_tpu_torch vs the JAX package (Pallas slab kernel in
interpret mode), on random planes and a seeded ~1000-point template."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder import point_blocks as jpb
from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.decoder.pallas_heads import _GELUS as JGELUS
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.neuralfield.renderer import build_slab_volume as jbuild_vol
from gaussian_gan_decoder_tpu.port.torch_export import decoder_state_dict
from gaussian_gan_decoder_tpu.splat.projection import project_channels as jproject
from gaussian_gan_decoder_tpu_torch.decoder import point_blocks as tpb
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.pallas_heads import (
    GELUS, PROJ_ROWS, decode_project_slab, softplus,
)
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import build_slab_volume
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_decoder_state
from gaussian_gan_decoder_tpu_torch.splat.projection import project_channels
from _torch_threads import torch_threads  # noqa: F401  (autouse)

GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, channel_base=512,
              channel_max=32, num_fp16_res=0)
TS, M, BLOCK, IMG, FOV = 32, 1000, 256, 64, 0.227


def template(m=M, seed=5):
    return ((np.random.RandomState(seed).rand(m, 3) - 0.5) * 0.4).astype(np.float32)


def head_params(jd, seed):
    """The JAX decoder's head parameters (torch.nn.Linear init), drawn with
    numpy: cheaper than tracing the JAX init."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, head in jd._heads().items():
        params[name] = {}
        for i, (din, dout) in enumerate(head._dims()):
            b = 1.0 / np.sqrt(din)
            params[name][f"fc{i}"] = {
                "weight": jnp.asarray(rng.uniform(-b, b, (dout, din)).astype(np.float32)),
                "bias": jnp.asarray(rng.uniform(-b, b, (dout,)).astype(np.float32))}
    return params


@pytest.fixture(scope="module")
def slab():
    jg = JGen(without_sr=True, rendering_kwargs=(("triplane_size", TS),), **GEN_KW)
    jd = JDec(generator=jg, decoder_type="sequential_reversed", int8_sampling=True,
              pallas_heads=True, heads_bf16=True, gelu="poly6", slab_sampling=True)
    params = head_params(jd, 0)
    td = GaussianDecoder(TriPlaneGenerator(rendering_kwargs={"triplane_size": TS}, **GEN_KW),
                         pallas_heads=True, heads_bf16=True)
    heads_sd = {k: v for k, v in decoder_state_dict(jd, params).items()}
    heads_sd.update({f"G.{k}": v for k, v in td.G.state_dict().items()})
    load_decoder_state(td, heads_sd)
    planes = np.random.RandomState(6).randn(1, 3, 96, TS, TS).astype(np.float32)
    pos = template()
    jctx = jd.make_slab_context(pos, block=BLOCK)
    _, c2w = jcam_params()
    jcam = jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), c2w)
    jrows, layout = jd.decode_project(params, jnp.asarray(planes), jnp.asarray(pos), jcam,
                                      slab_ctx=jctx)
    return dict(jd=jd, td=td, planes=planes, pos=pos, jctx=jctx, c2w=np.asarray(c2w),
                jrows=np.asarray(jrows), layout=layout)


def test_slab_volume_bit_exact(slab):
    vol, scales = build_slab_volume(torch.tensor(slab["planes"]), 3)
    jvol, jscales = jbuild_vol(jnp.asarray(slab["planes"]), 3)
    np.testing.assert_array_equal(vol.numpy(), np.asarray(jvol))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))


def test_host_pack_bit_exact(slab, tmp_path):
    pos = slab["pos"]
    axes = slab["td"].G.plane_axes
    sizes = (3, TS, TS)
    pb = tpb.build_point_blocks(pos, axes, box_warp=1.0, sizes=sizes, block=BLOCK)
    jb = jpb.build_point_blocks(pos, axes, box_warp=1.0, sizes=sizes, block=BLOCK)
    for f in ("perm", "valid", "origins", "positions"):
        np.testing.assert_array_equal(getattr(pb, f), getattr(jb, f))
    np.testing.assert_array_equal(tpb.compact_indices(pb, axes, 1.0, sizes),
                                  jpb.compact_indices(jb, axes, 1.0, sizes))
    # the decoder's context carries the same pack; the npz cache reloads it
    jctx = slab["jctx"]
    for cache in (str(tmp_path), str(tmp_path)):
        ctx = slab["td"].make_slab_context(pos, block=BLOCK, cache_dir=cache)
        np.testing.assert_array_equal(ctx.perm, np.asarray(jctx.perm))
        np.testing.assert_array_equal(ctx.origins, np.asarray(jctx.origins))
        np.testing.assert_array_equal(ctx.valid.numpy(), np.asarray(jctx.valid))
        np.testing.assert_array_equal(ctx.inv_slot.numpy(), np.asarray(jctx.inv_slot))
        np.testing.assert_array_equal(ctx.aux.float().numpy(),
                                      np.asarray(jctx.aux.astype(jnp.float32)))
    assert len(list(tmp_path.glob("slab_pack_*.npz"))) == 1


def test_decode_rows_match_jax_slab_kernel(slab):
    """rows 0:14 (raw heads) within 5e-2 of each row's max, screen rows
    px/py/depth/opac within 5e-2, visibility agreement >= 0.995, pad slots
    culled exactly. The JAX kernel lerps with int8-quantised (z,y) weights
    and bf16 products; the port uses f32 corner weights."""
    td = slab["td"]
    ctx = td.make_slab_context(slab["pos"], block=BLOCK)
    cam = make_camera(IMG, FOV, slab["c2w"])
    vol, scales = build_slab_volume(torch.tensor(slab["planes"]), 3)
    before = decode_project_slab.launches
    rows = decode_project_slab(td.fold().chain, vol, scales, ctx, cam).numpy()
    assert decode_project_slab.launches == before
    jrows = slab["jrows"]
    assert rows.shape == jrows.shape
    v = ctx.valid.numpy() > 0
    a, b = jrows[:14][:, v], rows[:14][:, v]
    err = np.abs(a - b) / np.maximum(np.abs(a).max(axis=1, keepdims=True), 1e-3)
    print(f"K2 plain vs JAX slab kernel: rows 0:14 max row-relative err {err.max():.3e}")
    assert err.max() < 5e-2, err.max(axis=1)
    for k in ("px", "py", "depth", "opac"):
        r = PROJ_ROWS[k]
        e = np.abs(jrows[r, v] - rows[r, v]).max() / np.abs(jrows[r, v]).max()
        print(f"  {k}: {e:.3e}")
        assert e < 5e-2, (k, e)
    vis_j, vis_t = jrows[PROJ_ROWS["visible"]] > 0.5, rows[PROJ_ROWS["visible"]] > 0.5
    print(f"  visible agreement {(vis_j[v] == vis_t[v]).mean():.5f}")
    assert (vis_j[v] == vis_t[v]).mean() >= 0.995
    assert vis_t[v].mean() > 0.5
    for k in ("visible", "opac", "radius_f"):
        assert np.all(rows[PROJ_ROWS[k], ~v] == 0.0), k
    assert np.all(rows[14:16] == 0.0) and np.all(rows[28:] == 0.0)
    assert np.isfinite(rows).all()


@pytest.mark.parametrize("name", ["exact", "tanh", "poly", "poly6"])
def test_gelu_variants(name):
    x = np.linspace(-6.0, 6.0, 2001, dtype=np.float32)
    ref = np.asarray(JGELUS[name](jnp.asarray(x)))
    np.testing.assert_allclose(GELUS[name](torch.tensor(x)).numpy(), ref, rtol=1e-5,
                               atol=1e-6)


def test_softplus_matches_jax():
    x = np.linspace(-40.0, 40.0, 801, dtype=np.float32)
    np.testing.assert_allclose(softplus(torch.tensor(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


def test_project_channels_matches_jax(slab):
    rng = np.random.RandomState(7)
    n = 512
    mean = template(n, seed=8)
    q = rng.randn(4, n).astype(np.float32)
    s = np.exp(rng.randn(3, n).astype(np.float32) - 5.0)
    jcam = jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), jnp.asarray(slab["c2w"]))
    ref = jproject(jcam, *(jnp.asarray(mean[:, i]) for i in range(3)),
                   tuple(jnp.asarray(v) for v in q), tuple(jnp.asarray(v) for v in s))
    out = project_channels(make_camera(IMG, FOV, slab["c2w"]),
                           *(torch.tensor(mean[:, i]) for i in range(3)),
                           tuple(torch.tensor(v) for v in q), tuple(torch.tensor(v) for v in s))
    for k in ("px", "py", "depth", "conic_a", "conic_b", "conic_c", "radius_f"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(out["visible"].numpy(), np.asarray(ref["visible"]))
