"""Port parity of the brick route's decode kernels' plain versions vs the
JAX package's Pallas kernels (interpret mode): decode_project (kernel K8)
against decode_project_pallas, decode_project_fused (kernel K9) against
decode_project_pallas_fused in both lerp forms, and sample_fused_inputs,
at the JAX test's sizes (tests/test_pallas_heads.py): M = 300 points
spread past the box, block 128, a 16^2 tri-grid of depth 3, bf16 chain
with the polynomial GELU, random heads drawn with numpy.

Tolerances. K8 against the JAX kernel on equal staging: K2's (rows 0:14
within 5e-2 of each row's max, px/py/depth/opac within 5e-2, visibility
agreement >= 0.995), the pad columns not visible. K9: within 1e-3 (abs)
of the JAX kernel in each of its lerps, 'bcast' (f32) and 'dots' (bf16
weights and products), which the port computes in the same form; what
remains is the order of the sums and the chain's. sample_fused_inputs:
the gathered rows bit-exact (exact indices), the corner weights within
1e-7, the scale rows within one f32 rounding of what the JAX kernel
recovers from its segment matrices (column sums over the 8 corners / 8)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import _CHAINS
from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.decoder.pallas_heads import (
    decode_project_pallas, decode_project_pallas_fused)
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.neuralfield.renderer import generate_planes
from gaussian_gan_decoder_tpu.neuralfield.renderer import sample_fused_inputs as jfused_inputs
from gaussian_gan_decoder_tpu.port.torch_export import decoder_state_dict
from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import sample_fused_inputs
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_decoder_state
from test_torch_slab_decode import head_params
from _torch_threads import torch_threads  # noqa: F401  (autouse)

GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, channel_base=512,
              channel_max=32, num_fp16_res=0)
TS, M, BLOCK, IMG, FOV = 16, 300, 128, 64, 0.227
MPAD = -(-M // BLOCK) * BLOCK
PR = pallas_heads.PROJ_ROWS


@pytest.fixture(scope="module")
def setup():
    jg = JGen(without_sr=True, rendering_kwargs=(("triplane_size", TS),), **GEN_KW)
    jd = JDec(generator=jg, decoder_type="sequential_reversed", int8_sampling=True,
              pallas_heads=True, heads_bf16=True, gelu="poly")
    params = head_params(jd, 1)
    td = GaussianDecoder(TriPlaneGenerator(rendering_kwargs={"triplane_size": TS}, **GEN_KW),
                         gelu="poly", pallas_heads=True, heads_bf16=True)
    sd = dict(decoder_state_dict(jd, params))
    sd.update({f"G.{k}": v for k, v in td.G.state_dict().items()})
    load_decoder_state(td, sd)
    rng = np.random.RandomState(2)
    planes = rng.randn(1, 3, 32 * 3, TS, TS).astype(np.float32)
    pos = ((rng.rand(M, 3) - 0.5) * 1.3).astype(np.float32)
    _, c2w = jcam_params()
    chain = _CHAINS["sequential_reversed"]
    return dict(
        jd=jd, hp={name: params[name] for name, _ in chain}, chain=chain,
        cw=td.fold().chain, planes=planes, pos=pos,
        jcam=jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), c2w),
        cam=make_camera(IMG, FOV, np.asarray(c2w)))


def _k2_tolerances(rows, jrows, label):
    """K2's tolerances on the real columns; pad columns not visible."""
    a, b = jrows[:14, :M], rows[:14, :M]
    err = np.abs(a - b) / np.maximum(np.abs(a).max(axis=1, keepdims=True), 1e-3)
    print(f"{label}: rows 0:14 worst row-relative {err.max():.3e}")
    assert err.max() < 5e-2, err.max(axis=1)
    for k in ("px", "py", "depth", "opac"):
        e = np.abs(jrows[PR[k], :M] - rows[PR[k], :M]).max() / np.abs(jrows[PR[k], :M]).max()
        print(f"  {k}: {e:.3e}")
        assert e < 5e-2, (k, e)
    vis, jvis = rows[PR["visible"]] > 0.5, jrows[PR["visible"]] > 0.5
    agree = (vis[:M] == jvis[:M]).mean()
    print(f"  visible agreement {agree:.5f}, {int(vis[:M].sum())} of {M} visible")
    assert agree >= 0.995 and vis[:M].mean() > 0.2
    assert not vis[M:].any() and not jvis[M:].any()
    assert np.all(rows[14:16] == 0.0) and np.all(rows[28:] == 0.0)
    assert np.isfinite(rows).all()


def test_decode_project_matches_jax(setup):
    """The plain K8 on the bf16 staging of seeded plane-mean features."""
    s = setup
    fm = np.random.RandomState(4).randn(M, 32).astype(np.float32) * 0.5
    pos = s["pos"]
    jrows, _ = decode_project_pallas(
        s["hp"], s["chain"], jnp.asarray(fm), jnp.asarray(pos), jnp.asarray(pos),
        s["jd"].scale_offset, cam=s["jcam"], n_points=M, compute_dtype=jnp.bfloat16,
        block=BLOCK, interpret=True, gelu="poly")
    staging, Mpad = pallas_heads.build_brick_staging(
        torch.tensor(fm), torch.tensor(pos), torch.tensor(pos), block=BLOCK)
    assert Mpad == MPAD and staging.dtype == torch.bfloat16
    assert not staging[M:].float().any()
    before = pallas_heads.decode_project.launches
    rows = pallas_heads.decode_project(s["cw"], staging, s["cam"], M)
    assert pallas_heads.decode_project.launches == before
    jrows = np.asarray(jrows)
    assert tuple(rows.shape) == jrows.shape == (pallas_heads.NROWS, MPAD)
    _k2_tolerances(rows.numpy(), jrows, "K8 plain vs JAX decode_project_pallas")


def _jax_fused_inputs(s):
    return jfused_inputs(generate_planes("panohead"), jnp.asarray(s["planes"]),
                         jnp.asarray(s["pos"])[None], box_warp=1.0, triplane_depth=3,
                         brick_dtype=jnp.int8, pallas_build=True, pad_to=MPAD)


def _scale_rows(jsmats, K, lerp_mode="bcast"):
    """The per-(plane, channel) scale each JAX lerp uses: 'bcast' recovers it
    from the segment matrices (column sums over the K corners / K), 'dots'
    reads the matrices' entries (which the port rounds to bf16, as the JAX
    kernel does)."""
    if lerp_mode == "dots":
        return np.ascontiguousarray(np.asarray(jsmats)[:, np.arange(32), np.arange(32)])
    return np.asarray(jsmats).sum(axis=1) / K


def test_sample_fused_inputs_match_jax(setup):
    s = setup
    jrows, jwts, jsmats, jK = _jax_fused_inputs(s)
    rows, wts, scale_rows = sample_fused_inputs(
        generate_planes("panohead"), torch.tensor(s["planes"]), torch.tensor(s["pos"])[None],
        1.0, 3, pad_to=MPAD)
    assert jK == pallas_heads.CORNERS and len(rows) == len(jrows) == 3
    for r, jr in zip(rows, jrows):
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert tuple(wts.shape) == jwts.shape == (24, MPAD)
    np.testing.assert_allclose(wts.numpy(), np.asarray(jwts), rtol=0, atol=1e-7)
    assert not wts[:, M:].any()
    assert tuple(scale_rows.shape) == (3, 32) and scale_rows.dtype == torch.float32
    np.testing.assert_allclose(scale_rows.numpy(), _scale_rows(jsmats, jK), rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("lerp_mode,atol", [("bcast", 1e-3), ("dots", 1e-3)])
def test_decode_project_fused_matches_jax(setup, lerp_mode, atol):
    """The plain K9 on the JAX side's own fused inputs."""
    s = setup
    jrows_in, jwts, jsmats, K = _jax_fused_inputs(s)
    pos = jnp.asarray(s["pos"])
    ref, _ = decode_project_pallas_fused(
        s["hp"], s["chain"], jrows_in, jwts, jsmats, K, pos, pos, s["jd"].scale_offset,
        cam=s["jcam"], n_points=M, compute_dtype=jnp.bfloat16, block=BLOCK, interpret=True,
        gelu="poly", lerp_mode=lerp_mode)
    tpos = torch.tensor(s["pos"])
    aux, _ = pallas_heads.build_brick_staging(torch.zeros(M, 32), tpos, tpos, block=BLOCK)
    before = pallas_heads.decode_project_fused.launches
    rows = pallas_heads.decode_project_fused(
        s["cw"], aux, [torch.tensor(np.asarray(r)) for r in jrows_in],
        torch.tensor(np.asarray(jwts)), torch.tensor(_scale_rows(jsmats, K, lerp_mode)),
        s["cam"], M, lerp=lerp_mode)
    assert pallas_heads.decode_project_fused.launches == before
    ref, rows = np.asarray(ref), rows.numpy()
    assert rows.shape == ref.shape == (pallas_heads.NROWS, MPAD)
    # rows 14:16 are unwritten scratch in the JAX kernel, zeros in the port
    assert np.all(rows[14:16] == 0.0)
    keep = [r for r in range(pallas_heads.NROWS) if r not in (14, 15)]
    err = np.abs(rows[keep, :M] - ref[keep, :M]).max(axis=1)
    print(f"K9 plain vs JAX fused ({lerp_mode}): max |d| {err.max():.3e} "
          f"(row {keep[err.argmax()]})")
    assert err.max() <= atol, err
    assert not (rows[PR["visible"], M:] > 0.5).any()
