"""Port parity of the EG3D tri-plane (depth-1) decode pieces vs the JAX
package, at the tiny EG3D generator's shapes (tests/test_models_triplane.py:
z/w 32, 32^2 tri-planes of 3 x 32 channels): the bilinear slab pack and
the depth-1 slab volume, K2's bilinear form (the plain version) against the
JAX slab kernel in interpret mode, K9's tri-plane form (4 bf16 corners, no
dequant scale) against the JAX fused kernel's 'bcast' lerp, and the
bilinear sample and table the table route and the train step use.

Tolerances. The pack, the volume, the table and the fused inputs' rows are
bit-exact (same integer arithmetic and copies); the fused inputs' corner
weights within 1e-7 and the scale rows within one f32 rounding of what the
JAX kernel recovers from its segment matrices. K2 and the table route (K8):
K2's tolerances (tests/test_torch_decode_project.py::_k2_tolerances: rows
0:14 within 5e-2 of each row's max, px/py/depth/opac within 5e-2,
visibility agreement >= 0.995): the JAX slab kernel lerps with
int8-quantised y weights and bf16 products, the port in f32. K9 within
1e-3 (abs) of the JAX 'bcast' lerp, which the port computes (as at
tests/test_torch_decode_project.py:138). The float bilinear sample within
1e-6 of the JAX one (same products; f32 rounding of the projection), its
gradient with respect to the planes within 1e-5 of jax.grad's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder import point_blocks as jpb
from gaussian_gan_decoder_tpu.decoder.heads import _CHAINS
from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.decoder.pallas_heads import decode_project_pallas_fused
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.neuralfield import renderer as jrenderer
from gaussian_gan_decoder_tpu.port.torch_export import decoder_state_dict
from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads
from gaussian_gan_decoder_tpu_torch.decoder import point_blocks as tpb
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield import renderer
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_decoder_state
from test_torch_slab_decode import head_params
from _torch_threads import torch_threads  # noqa: F401  (autouse)

# tests/test_models_triplane.py::tiny_generator("eg3d")
GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, img_channels=3,
              channel_base=1024, channel_max=64, without_sr=True)
RK = {"triplane_size": 32, "depth_resolution": 8, "depth_resolution_importance": 8,
      "c_gen_conditioning_zero": True}
TS, M, BLOCK, IMG, FOV = 32, 1000, 256, 64, 0.227
MPAD = -(-M // 1024) * 1024     # the brick routes' padding (block 1024)
PR = pallas_heads.PROJ_ROWS
AXES = renderer.generate_planes("eg3d")


@pytest.fixture(scope="module")
def eg3d():
    jg = JGen(variant="eg3d", rendering_kwargs=tuple(RK.items()), **GEN_KW)
    jd = JDec(generator=jg, decoder_type="sequential_reversed", int8_sampling=True,
              pallas_heads=True, heads_bf16=True, gelu="poly", slab_sampling=True)
    params = head_params(jd, 3)
    td = GaussianDecoder(TriPlaneGenerator(variant="eg3d", rendering_kwargs=RK, **GEN_KW),
                         gelu="poly")
    sd = dict(decoder_state_dict(jd, params))
    sd.update({f"G.{k}": v for k, v in td.G.state_dict().items()})
    load_decoder_state(td, sd)
    rng = np.random.RandomState(11)
    planes = rng.randn(1, 3, 32, TS, TS).astype(np.float32)
    # the flagship template's spread, and some points past the planes' border
    pos = ((rng.rand(M, 3) - 0.5) * 0.4).astype(np.float32)
    pos[:40] *= 3.0
    _, c2w = jcam_params()
    return dict(jd=jd, params=params, td=td, planes=planes, pos=pos,
                chain=_CHAINS["sequential_reversed"],
                jcam=jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), c2w),
                cam=make_camera(IMG, FOV, np.asarray(c2w)))


def _k2_tolerances(rows, jrows, real, label):
    """K2's tolerances on the real columns; the other columns not visible."""
    a, b = jrows[:14][:, real], rows[:14][:, real]
    err = np.abs(a - b) / np.maximum(np.abs(a).max(axis=1, keepdims=True), 1e-3)
    print(f"{label}: rows 0:14 worst row-relative {err.max():.3e}")
    assert err.max() < 5e-2, err.max(axis=1)
    for k in ("px", "py", "depth", "opac"):
        e = np.abs(jrows[PR[k], real] - rows[PR[k], real]).max() / np.abs(jrows[PR[k], real]).max()
        print(f"  {k}: {e:.3e}")
        assert e < 5e-2, (k, e)
    vis, jvis = rows[PR["visible"]] > 0.5, jrows[PR["visible"]] > 0.5
    agree = (vis[real] == jvis[real]).mean()
    print(f"  visible agreement {agree:.5f}, {int(vis[real].sum())} of {int(real.sum())}")
    assert agree >= 0.995 and vis[real].mean() > 0.5
    assert not vis[~real].any() and not jvis[~real].any()
    assert np.all(rows[14:16] == 0.0) and np.all(rows[28:] == 0.0)
    assert np.isfinite(rows).all()


def test_bilinear_pack_and_volume_bit_exact(eg3d, tmp_path):
    """The bilinear pack (2-D windows, ey 40 = min(128, roundup(34, 8)))
    and its compact indices (z bit always set), the decoder's slab context
    (through the npz cache too) and the depth-1 slab volume (3, 1, YP,
    XP*32), bit for bit against the JAX package."""
    pos, td = eg3d["pos"], eg3d["td"]
    sizes, ey = (1, TS, TS), 40
    pb = tpb.build_point_blocks(pos, AXES, 1.0, sizes, block=BLOCK, ey=ey, bilinear=True)
    jb = jpb.build_point_blocks(pos, AXES, 1.0, sizes, block=BLOCK, ey=ey, bilinear=True)
    for f in ("perm", "valid", "origins", "positions", "idxw"):
        np.testing.assert_array_equal(getattr(pb, f), getattr(jb, f), err_msg=f)
    idx = tpb.compact_indices(pb, AXES, 1.0, sizes, bilinear=True)
    np.testing.assert_array_equal(idx, jpb.compact_indices(jb, AXES, 1.0, sizes, bilinear=True))
    assert np.all(idx[:, 3::4] & (1 << 4)) and not np.any(idx[:, 3::4] & (1 << 5))
    assert not idx[:, 2::4].any()
    jctx = eg3d["jd"].make_slab_context(pos, block=BLOCK)
    assert (jctx.ey, jctx.dzw) == (ey, 1)
    for cache in (str(tmp_path), str(tmp_path)):
        ctx = td.make_slab_context(pos, block=BLOCK, cache_dir=cache)
        assert ctx.sizes == sizes and ctx.m_padded == jctx.m_padded
        np.testing.assert_array_equal(ctx.perm, np.asarray(jctx.perm))
        np.testing.assert_array_equal(ctx.origins, np.asarray(jctx.origins))
        np.testing.assert_array_equal(ctx.idx16.numpy(), idx)
        np.testing.assert_array_equal(ctx.inv_slot.numpy(), np.asarray(jctx.inv_slot))
        np.testing.assert_array_equal(ctx.aux.float().numpy(),
                                      np.asarray(jctx.aux.astype(jnp.float32)))
    assert len(list(tmp_path.glob("slab_pack_*.npz"))) == 1
    vol, scales = renderer.build_slab_volume(torch.tensor(eg3d["planes"]), 1)
    jvol, jscales = jrenderer.build_slab_volume(jnp.asarray(eg3d["planes"]), 1)
    assert tuple(vol.shape) == (3, 1, 40, 36 * 32)
    np.testing.assert_array_equal(vol.numpy(), np.asarray(jvol))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))


def test_k2_bilinear_matches_jax(eg3d):
    """GaussianDecoder.decode_project on the slab route (K2's bilinear
    form, plain version on the CPU) against the JAX decoder's (the Pallas
    slab kernel with dzw 1, interpret mode), in slot order."""
    jd, td, planes, pos = eg3d["jd"], eg3d["td"], eg3d["planes"], eg3d["pos"]
    jctx = jd.make_slab_context(pos, block=BLOCK)
    jrows, jlayout = jd.decode_project(eg3d["params"], jnp.asarray(planes), jnp.asarray(pos),
                                       eg3d["jcam"], slab_ctx=jctx)
    ctx = td.make_slab_context(pos, block=BLOCK)
    before = pallas_heads.decode_project_slab.launches
    rows, layout = td.decode_project(td.fold(), torch.tensor(planes), eg3d["cam"], slab_ctx=ctx)
    assert pallas_heads.decode_project_slab.launches == before
    assert layout == dict(jlayout)
    rows, jrows = rows.numpy(), np.asarray(jrows)
    assert rows.shape == jrows.shape == (pallas_heads.NROWS, ctx.m_padded)
    _k2_tolerances(rows, jrows, ctx.valid.numpy() > 0, "K2 bilinear plain vs JAX slab kernel")


def _jax_fused_inputs(s):
    return jrenderer.sample_fused_inputs(
        AXES, jnp.asarray(s["planes"]), jnp.asarray(s["pos"])[None], box_warp=1.0,
        triplane_depth=1, brick_dtype=jnp.bfloat16, pad_to=MPAD)


def test_k9_triplane_matches_jax(eg3d):
    """sample_fused_inputs at depth 1 (4 bf16 corners a plane) against the
    JAX function, then K9's tri-plane form (plain version) on the JAX
    side's own inputs against decode_project_pallas_fused ('bcast',
    interpret mode), and the decoder's fused route end to end against the
    JAX decoder's with the 'bcast' lerp."""
    s = eg3d
    jrows_in, jwts, jsmats, K = _jax_fused_inputs(s)
    rows_in, wts, scale_rows = renderer.sample_fused_inputs(
        AXES, torch.tensor(s["planes"]), torch.tensor(s["pos"])[None], 1.0, 1, pad_to=MPAD)
    assert K == 4 and len(rows_in) == 3
    for r, jr in zip(rows_in, jrows_in):
        assert r.dtype == torch.bfloat16 and tuple(r.shape) == (MPAD, 4 * 32)
        np.testing.assert_array_equal(r.float().numpy(), np.asarray(jr.astype(jnp.float32)))
    assert tuple(wts.shape) == jwts.shape == (16, MPAD)
    np.testing.assert_allclose(wts.numpy(), np.asarray(jwts), rtol=0, atol=1e-7)
    jscale = np.asarray(jsmats).sum(axis=1) / K
    np.testing.assert_allclose(scale_rows.numpy(), jscale, rtol=1.2e-7, atol=0)

    pos = jnp.asarray(s["pos"])
    hp = {name: s["params"][name] for name, _ in s["chain"]}
    ref, _ = decode_project_pallas_fused(
        hp, s["chain"], jrows_in, jwts, jsmats, K, pos, pos, s["jd"].scale_offset,
        cam=s["jcam"], n_points=M, compute_dtype=jnp.bfloat16, interpret=True, gelu="poly",
        lerp_mode="bcast")
    cw = s["td"].fold().chain
    tpos = torch.tensor(s["pos"])
    aux, _ = pallas_heads.build_brick_staging(torch.zeros(M, 32), tpos, tpos)
    before = pallas_heads.decode_project_fused.launches
    rows = pallas_heads.decode_project_fused(
        cw, aux, [torch.tensor(np.asarray(r.astype(jnp.float32))).bfloat16() for r in jrows_in],
        torch.tensor(np.asarray(jwts)), torch.tensor(jscale), s["cam"], M)
    assert pallas_heads.decode_project_fused.launches == before
    ref, rows = np.asarray(ref), rows.numpy()
    assert rows.shape == ref.shape == (pallas_heads.NROWS, MPAD)
    keep = [r for r in range(pallas_heads.NROWS) if r not in (14, 15)]  # JAX scratch rows
    err = np.abs(rows[keep, :M] - ref[keep, :M]).max(axis=1)
    print(f"K9 tri-plane plain vs JAX fused (bcast): max |d| {err.max():.3e}")
    assert err.max() <= 1e-3, err
    assert not (rows[PR["visible"], M:] > 0.5).any()

    # the decoder's fused route: bf16 table, the gathers, K9
    jdf = dataclasses.replace(s["jd"], slab_sampling=False, fused_sampling=True,
                              fused_lerp="bcast")
    jrows, _ = jdf.decode_project(s["params"], jnp.asarray(s["planes"]), pos, s["jcam"])
    dec = GaussianDecoder(s["td"].G, gelu="poly", fused_sampling=True)
    dec.load_state_dict(s["td"].state_dict())
    drows, _ = dec.decode_project(dec.fold(), torch.tensor(s["planes"]), s["cam"],
                                  init_position=tpos)
    d = np.abs(drows.numpy()[keep, :M] - np.asarray(jrows)[keep, :M]).max()
    print(f"  fused route vs the JAX decoder's: max |d| {d:.3e}")
    assert d <= 1e-3


def test_bilinear_table_route_matches_jax(eg3d):
    """build_plane_table at depth 1 (bf16, the table route's) bit-exact
    with the JAX _bilinear_table; its sample within 1e-6 of the JAX one;
    the decoder's table route (bilinear table sample, plane mean, K8's
    plain version) against the JAX decoder's at K2's tolerances."""
    s = eg3d
    planes, pos = torch.tensor(s["planes"]), torch.tensor(s["pos"])
    table = renderer.build_plane_table(planes, 1, brick_dtype=torch.bfloat16)
    jtable = jrenderer.build_plane_table(jnp.asarray(s["planes"]), 1, brick_dtype=jnp.bfloat16)
    assert len(table) == len(jtable) == 1 and table[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(table[0].float().numpy(),
                                  np.asarray(jtable[0].astype(jnp.float32)))
    with pytest.raises(ValueError, match="int8"):
        renderer.build_plane_table(planes, 1, brick_dtype=torch.int8)
    feats = renderer.sample_from_planes(AXES, planes, pos[None], 1.0, 1, table=table)
    jfeats = jrenderer.sample_from_planes(AXES, jnp.asarray(s["planes"]),
                                          jnp.asarray(s["pos"])[None], 1.0, 1,
                                          brick_dtype=jnp.bfloat16)
    assert feats.dtype == torch.float32 and tuple(feats.shape) == (1, 3, M, 32)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0, atol=1e-6)

    jdt = dataclasses.replace(s["jd"], slab_sampling=False)
    jrows, _ = jdt.decode_project(s["params"], jnp.asarray(s["planes"]), jnp.asarray(s["pos"]),
                                  s["jcam"])
    before = pallas_heads.decode_project.launches
    rows, _ = s["td"].decode_project(s["td"].fold(), planes, s["cam"], init_position=pos)
    assert pallas_heads.decode_project.launches == before
    real = np.arange(MPAD) < M
    _k2_tolerances(rows.numpy(), np.asarray(jrows), real, "table route (K8 plain) vs JAX")


def test_bilinear_sample_and_gradient_match_jax(eg3d):
    """The float bilinear sample without a table (the train step's and the
    volume renderer's) against the JAX sample_from_planes at depth 1, and
    its gradient with respect to the planes (autograd's scatter) against
    jax.grad, under a seeded cotangent."""
    s = eg3d
    rng = np.random.RandomState(12)
    cot = rng.randn(1, 3, M, 32).astype(np.float32)
    planes = torch.tensor(s["planes"], requires_grad=True)
    out = renderer.sample_from_planes(AXES, planes, torch.tensor(s["pos"])[None], 1.0, 1)
    (out * torch.tensor(cot)).sum().backward()

    def jfn(p):
        f = jrenderer.sample_from_planes(AXES, p, jnp.asarray(s["pos"])[None], 1.0, 1)
        return jnp.sum(f * jnp.asarray(cot)), f

    (_, jout), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(s["planes"]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-6)
    g, jg = planes.grad.numpy(), np.asarray(jgrad)
    print(f"bilinear sample gradient: max |d| {np.abs(g - jg).max():.3e} "
          f"(max {np.abs(jg).max():.3e})")
    assert np.abs(jg).max() > 0.1
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-5)
