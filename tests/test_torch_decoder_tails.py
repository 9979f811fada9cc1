"""Port parity of the decoder options' kernel forms (their plain versions)
against the JAX package's Pallas kernels in interpret mode, at the JAX
tests' small sizes (M = 300 points spread past the box, block 128, a 16^2
tri-grid of depth 3 or a 32^2 tri-plane, random heads drawn with numpy),
for the three decoder types with and without the xyz embedding:

- the xyz embedding (decoder/pos_encoding.py) against JAX's Embedder, and
  the parallel chain's pack (every stage column 128: nothing written back)
  against the plain per-head decode;
- decode_heads_pallas at bf16 (K6's bf16 form) against decode_heads_plain
  on a bf16 chain: each output column within 5e-2 of its scale (the JAX
  bf16 tests' limit);
- decode_project_pallas at f32 (K8-f32) and decode_project_pallas_fused at
  f32 ('bcast'; K = 8 int8 tri-grid rows and K = 4 bf16 tri-plane rows,
  K9-f32) against decode_project_plain / decode_project_fused_plain on an
  f32 chain: rows 0:14 and the continuous screen rows (px, py, conics,
  opacity, colour, depth) within 1e-4 of each row's scale (the JAX f32
  tests' limit), radius within one pixel (a ceil), visibility agreement >=
  0.995, the pad columns not visible. Rows 14-15 are the JAX kernels'
  unwritten scratch (NaN in interpret mode) and zeros in the port: not
  compared."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import _CHAINS
from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.decoder.pallas_heads import (
    decode_heads_pallas, decode_project_pallas, decode_project_pallas_fused)
from gaussian_gan_decoder_tpu.decoder.pos_encoding import Embedder as JEmbedder
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.neuralfield import renderer as jrenderer
from gaussian_gan_decoder_tpu.port.torch_export import decoder_state_dict
from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.pos_encoding import Embedder
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_decoder_state
from test_torch_slab_decode import head_params
from _torch_threads import torch_threads  # noqa: F401  (autouse)

GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, channel_base=512,
              channel_max=32, num_fp16_res=0)
TS, M, BLOCK, IMG, FOV = 16, 300, 128, 64, 0.227
MPAD = -(-M // BLOCK) * BLOCK
PR = ph.PROJ_ROWS
TYPES = ("sequential_reversed", "sequential", "parallel")
# (decoder_type, use_xyz_embedding, gelu) of the f32 tails: D-par (the JAX
# GaussianDecoder's default dtype and GELU) and a sequential chain with the
# flagship's GELU
F32_DECODERS = (("parallel", True, "exact"), ("sequential", False, "poly"))


def decoder_pair(decoder_type, emb, gelu, seed, heads_bf16=False):
    """A JAX decoder of the options (int8 bricks), its head params drawn
    with numpy, and the port decoder holding the same heads (f32 chain, the
    default, or bf16)."""
    rk = {"triplane_size": TS}
    jd = JDec(generator=JGen(without_sr=True, rendering_kwargs=tuple(rk.items()), **GEN_KW),
              decoder_type=decoder_type, use_xyz_embedding=emb, int8_sampling=True, gelu=gelu)
    params = head_params(jd, seed)
    td = GaussianDecoder(TriPlaneGenerator(rendering_kwargs=rk, without_sr=True, **GEN_KW),
                         gelu=gelu, decoder_type=decoder_type, use_xyz_embedding=emb,
                         heads_bf16=heads_bf16)
    sd = dict(decoder_state_dict(jd, params))
    sd.update({f"G.{k}": v for k, v in td.G.state_dict().items()})
    load_decoder_state(td, sd)
    chain = _CHAINS[decoder_type]
    return jd, {name: params[name] for name, _ in chain}, chain, td


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(21)
    pos = ((rng.rand(M, 3) - 0.5) * 1.3).astype(np.float32)
    fm = (rng.randn(M, 32) * 0.5).astype(np.float32)
    _, c2w = jcam_params()
    return dict(pos=pos, fm=fm, planes=rng.randn(1, 3, 32 * 3, TS, TS).astype(np.float32),
                jcam=jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), c2w),
                cam=make_camera(IMG, FOV, np.asarray(c2w)))


def _hold_f32(rows, ref, label, n=M):
    """The f32 tails' limits (module docstring) on the first n columns."""
    cont = list(range(14)) + list(range(16, 26))
    err = (np.abs(rows[cont, :n] - ref[cont, :n])
           / np.maximum(np.abs(ref[cont, :n]).max(axis=1, keepdims=True), 1e-3)).max(axis=1)
    rad = np.abs(rows[PR["radius_f"], :n] - ref[PR["radius_f"], :n])
    vis, jvis = rows[PR["visible"]] > 0.5, ref[PR["visible"]] > 0.5
    agree = (vis[:n] == jvis[:n]).mean()
    print(f"{label}: worst row-relative {err.max():.3e} (row {cont[err.argmax()]}); radius "
          f"|d| max {rad.max():.0f}; visible agreement {agree:.4f}, {int(vis[:n].sum())} of {n}")
    assert err.max() <= 1e-4, dict(zip(cont, err.round(7)))
    assert rad.max() <= 1.0 and (rad == 0).mean() >= 0.99
    assert agree >= 0.995 and vis[:n].mean() > 0.2
    assert not vis[n:].any() and not jvis[n:].any()
    assert np.all(rows[14:16] == 0.0) and np.isfinite(rows).all()


def test_embedder_and_parallel_pack(inputs):
    """The xyz embedding within one f32 rounding of JAX's (both take the
    bands in float64 under the tests' x64); the parallel pack writes no
    output back (stage columns 128) and its packed chain equals the plain
    per-head decode at f32 (1e-5)."""
    pos = inputs["pos"]
    emb, jemb = Embedder(), JEmbedder(include_input=True, input_dims=3, num_freqs=10)
    assert emb.out_dim == jemb.out_dim == 63
    np.testing.assert_array_equal(emb.freq_bands, jemb.freq_bands)
    got = emb(torch.tensor(pos)).numpy()
    ref = np.asarray(jemb(jnp.asarray(pos))).astype(np.float32)
    assert got.dtype == np.float32 and got.shape == (M, 63)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    _, _, chain, td = decoder_pair("parallel", True, "exact", 5)
    cw = ph.pack_chain(td.heads(), chain, 63, td.scale_offset, "exact", parallel=True,
                       dtype=torch.float32)
    assert [sc for _, _, sc, _ in cw.chain] == [ph.STAGE] * 5
    assert cw.meta[6:11].tolist() == [ph.STAGE] * 5
    tpos, fm = torch.tensor(pos), torch.tensor(inputs["fm"])
    packed = ph.decode_heads_plain(ph.build_staging_f32(fm, td.cond0(tpos), tpos), cw)
    plain = td._decode_plain(fm, td.cond0(tpos), tpos)
    for name, (c, d) in cw.layout.items():
        ref = plain[name].detach().numpy()
        err = np.abs(packed[:, c:c + d].detach().numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, (name, err)


def test_bf16_chain_alone_matches_jax(inputs):
    """decode_heads_pallas at bf16 against the port's bf16 chain (K6's bf16
    form's plain version), for every type with and without the embedding."""
    pos, fm = inputs["pos"], inputs["fm"]
    for k, decoder_type in enumerate(TYPES):
        for emb in (False, True):
            jd, hp, chain, td = decoder_pair(decoder_type, emb, "poly", 10 + k, heads_bf16=True)
            jcond = jd.embedder(jnp.asarray(pos)) if emb else jnp.asarray(pos)
            jout, jlayout = decode_heads_pallas(
                hp, chain, jnp.asarray(fm), jcond, jnp.asarray(pos), jd.scale_offset,
                parallel=decoder_type == "parallel", compute_dtype=jnp.bfloat16, block=BLOCK,
                interpret=True, return_packed=True, gelu="poly")
            cw = td.fold().chain
            assert cw.w1.dtype == torch.bfloat16 and cw.layout == dict(jlayout)
            tpos = torch.tensor(pos)
            staging, _ = ph.build_brick_staging(torch.tensor(fm), td.cond0(tpos), tpos,
                                                block=BLOCK)
            out = ph.decode_heads(staging, cw).numpy()
            ref = np.asarray(jout)
            err = (np.abs(out[:M, :14] - ref[:M, :14])
                   / np.maximum(np.abs(ref[:M, :14]).max(axis=0), 1e-3)).max()
            print(f"bf16 chain {decoder_type} emb {emb}: worst column-relative {err:.3e}")
            assert err <= 5e-2
            assert not out[:, 14:].any()


def test_f32_decode_project_matches_jax(inputs):
    """decode_project_pallas at f32 (K8-f32) against decode_project's plain
    version on the f32 staging of the same features."""
    pos, fm = inputs["pos"], inputs["fm"]
    for k, (decoder_type, emb, gelu) in enumerate(F32_DECODERS):
        jd, hp, chain, td = decoder_pair(decoder_type, emb, gelu, 20 + k)
        jcond = jd.embedder(jnp.asarray(pos)) if emb else jnp.asarray(pos)
        ref, _ = decode_project_pallas(
            hp, chain, jnp.asarray(fm), jcond, jnp.asarray(pos), jd.scale_offset,
            cam=inputs["jcam"], n_points=M, parallel=decoder_type == "parallel",
            compute_dtype=jnp.float32, block=BLOCK, interpret=True, gelu=gelu)
        cw = td.fold().chain
        assert cw.w1.dtype == torch.float32
        tpos = torch.tensor(pos)
        staging, Mpad = ph.build_brick_staging(torch.tensor(fm), td.cond0(tpos), tpos,
                                               block=BLOCK, dtype=torch.float32)
        assert Mpad == MPAD and staging.dtype == torch.float32
        rows = ph.decode_project(cw, staging, inputs["cam"], M).numpy()
        _hold_f32(rows, np.asarray(ref), f"K8-f32 plain vs JAX ({decoder_type}, emb {emb})")


@pytest.mark.parametrize("variant", ["panohead", "eg3d"])
def test_f32_fused_matches_jax(inputs, variant):
    """decode_project_pallas_fused at f32 ('bcast') against the fused
    decode's plain version on the JAX side's own fused inputs: 8 int8
    corners a plane on the tri-grid (both F32_DECODERS), 4 bf16 corners on
    the EG3D tri-plane (D-par)."""
    pos = inputs["pos"]
    if variant == "panohead":
        depth, planes, cases = 3, inputs["planes"], F32_DECODERS
        brick = jnp.int8
    else:
        depth, cases, brick = 1, F32_DECODERS[:1], jnp.bfloat16
        planes = np.random.RandomState(22).randn(1, 3, 32, 32, 32).astype(np.float32)
    jrows, jwts, jsmats, K = jrenderer.sample_fused_inputs(
        jrenderer.generate_planes(variant), jnp.asarray(planes), jnp.asarray(pos)[None],
        box_warp=1.0, triplane_depth=depth, brick_dtype=brick, pallas_build=depth > 1,
        pad_to=MPAD)
    assert K == (8 if depth > 1 else 4)
    rows_in = [torch.tensor(np.asarray(r.astype(jnp.float32))).to(ph.FUSED_FORMS[K])
               for r in jrows]
    scale_rows = torch.tensor(np.asarray(jsmats).sum(axis=1) / K)
    for k, (decoder_type, emb, gelu) in enumerate(cases):
        jd, hp, chain, td = decoder_pair(decoder_type, emb, gelu, 30 + k)
        jpos = jnp.asarray(pos)
        ref, _ = decode_project_pallas_fused(
            hp, chain, jrows, jwts, jsmats, K, jd.embedder(jpos) if emb else jpos, jpos,
            jd.scale_offset, cam=inputs["jcam"], n_points=M,
            parallel=decoder_type == "parallel", compute_dtype=jnp.float32, block=BLOCK,
            interpret=True, gelu=gelu, lerp_mode="bcast")
        cw = td.fold().chain
        tpos = torch.tensor(pos)
        aux, _ = ph.build_brick_staging(torch.zeros(M, 32), td.cond0(tpos), tpos, block=BLOCK,
                                        dtype=torch.float32)
        rows = ph.decode_project_fused(cw, aux, rows_in, torch.tensor(np.asarray(jwts)),
                                       scale_rows, inputs["cam"], M).numpy()
        _hold_f32(rows, np.asarray(ref),
                  f"K9-f32 plain vs JAX ({variant}, K {K}, {decoder_type}, emb {emb})")
