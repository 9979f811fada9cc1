"""Port parity of K10's select form (the TPU kernel's second body,
_expand_kernel_select) and of the decoder's pallas_sampling option: the
select table (its plain version, from the channel-duplicated source) equals
the rotate table byte for byte and the JAX build_brick_table(select=True)
(interpret mode) on the rows the sampler indexes; the JAX condition for the
select form; and pallas_sampling="select" decodes equal pallas_sampling
True's (and the JAX decoder's) on the brick routes, depth 1 ignoring it."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.neuralfield.pallas_expand import build_brick_table as jbuild
from gaussian_gan_decoder_tpu.port.torch_export import decoder_state_dict
from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand
from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
    build_plane_table, sample_from_planes)
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_decoder_state
from test_torch_brick_table import _as_bits, _to_torch, _volume
from test_torch_slab_decode import head_params
from _torch_threads import torch_threads  # noqa: F401  (autouse)

GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64, channel_base=512,
              channel_max=32, num_fp16_res=0)
TS, M, IMG, FOV = 16, 300, 64, 0.227
B, C, D, H, W = 3, 32, 3, 16, 16


def test_select_table_matches_rotate_and_jax():
    """The select form's plain version from the duplicated source, int8,
    bf16 and f32: the rotate table byte for byte (padded rows y0 > H
    included), and the JAX Pallas select build (interpret mode) on the rows
    y0 <= H (its padded rows are unspecified)."""
    for dtype in ("int8", "bfloat16", "float32"):
        _select_table_case(dtype)


def _select_table_case(dtype):
    vol = _volume(dtype, 11)
    feats = _to_torch(jnp.asarray(vol).astype(dtype))
    e_sel, NY = pallas_expand.build_brick_table(feats, select=True)
    e_rot, NY2 = pallas_expand.build_brick_table(feats)
    assert NY == NY2
    fpd = pallas_expand.duplicated_channels_last(feats)
    assert fpd.shape == (B, D + 2, H + 2, W + 2, pallas_expand.LANE)
    assert torch.equal(fpd[..., C:2 * C], fpd[..., :C])
    np.testing.assert_array_equal(_as_bits(e_sel), _as_bits(e_rot))
    jtab, jNY = jbuild(jnp.asarray(vol).astype(dtype), select=True, interpret=True)
    assert jNY == NY
    got = _as_bits(e_sel).reshape(B, D + 1, NY, W + 1, 8 * C)[:, :, :H + 1]
    want = _as_bits(_to_torch(jtab)).reshape(B, D + 1, NY, W + 1, 8 * C)[:, :, :H + 1]
    np.testing.assert_array_equal(got, want)


def test_select_condition_and_option_checks():
    """select takes the duplicated source only where 128 % C == 0 and 8C %
    128 == 0 (JAX's condition), else the rotate form (no select launch);
    the wrapper refuses a source that is not duplicated; the decoder
    refuses an unknown pallas_sampling or fused_lerp."""
    assert pallas_expand.select_applies(32) and pallas_expand.select_applies(16)
    assert not pallas_expand.select_applies(48) and not pallas_expand.select_applies(8)
    feats = torch.randn(2, 48, 2, 5, 6)
    e48, NY = pallas_expand.build_brick_table(feats, select=True)
    assert torch.equal(e48, pallas_expand.build_brick_table(feats)[0])
    with pytest.raises(ValueError):
        pallas_expand.brick_table_select(pallas_expand.padded_channels_last(feats), NY, 48)
    with pytest.raises(ValueError):
        pallas_expand.brick_table_select(
            pallas_expand.padded_channels_last(torch.randn(2, 32, 2, 5, 6)), NY, 32)
    gen = TriPlaneGenerator(rendering_kwargs={"triplane_size": TS}, without_sr=True, **GEN_KW)
    for kw in ({"pallas_sampling": "rotate"}, {"fused_lerp": "mxu"}):
        with pytest.raises(ValueError):
            GaussianDecoder(gen, **kw)
    with pytest.raises(ValueError):
        build_plane_table(torch.zeros(1, 3, 96, 8, 8), 3, pallas_build="fast")
    # depth 1 (EG3D tri-planes) has its bilinear table whatever the build
    planes1 = torch.randn(1, 3, 32, 8, 8)
    assert torch.equal(build_plane_table(planes1, 1, pallas_build="select")[0],
                       build_plane_table(planes1, 1)[0])


@pytest.fixture(scope="module")
def pair():
    jg = JGen(without_sr=True, rendering_kwargs=(("triplane_size", TS),), **GEN_KW)
    jd = JDec(generator=jg, decoder_type="sequential_reversed", int8_sampling=True,
              pallas_heads=True, heads_bf16=True, gelu="poly", pallas_sampling="select")
    params = head_params(jd, 7)
    td = GaussianDecoder(TriPlaneGenerator(rendering_kwargs={"triplane_size": TS}, **GEN_KW),
                         gelu="poly", pallas_heads=True, heads_bf16=True,
                         pallas_sampling="select")
    sd = dict(decoder_state_dict(jd, params))
    sd.update({f"G.{k}": v for k, v in td.G.state_dict().items()})
    load_decoder_state(td, sd)
    rng = np.random.RandomState(8)
    _, c2w = jcam_params()
    return dict(jd=jd, params=params, td=td,
                planes=rng.randn(1, 3, 96, TS, TS).astype(np.float32),
                pos=((rng.rand(M, 3) - 0.5) * 1.2).astype(np.float32),
                jcam=jmake_camera(IMG, jnp.asarray(FOV, jnp.float32), c2w),
                cam=make_camera(IMG, FOV, np.asarray(c2w)))


def test_select_decodes_equal_true(pair):
    """pallas_sampling="select" against True on the table and fused routes
    ('dots' and 'bcast') and decode_packed: the same rows bit for bit (one
    table, two builds); the select build counted on its own wrapper only on
    a card (none here)."""
    td, cam = pair["td"], pair["cam"]
    planes, pos = torch.tensor(pair["planes"]), torch.tensor(pair["pos"])
    w = td.fold()
    assert td.config.pallas_sampling == "select"
    before = pallas_expand.brick_table_select.launches
    for fused, lerp in ((False, "dots"), (True, "dots"), (True, "bcast")):
        outs = []
        for sampling in ("select", True):
            td.config = dataclasses.replace(td.config, fused_sampling=fused, fused_lerp=lerp,
                                            pallas_sampling=sampling)
            outs.append(td.decode_project(w, planes, cam, init_position=pos)[0])
        assert torch.equal(outs[0], outs[1]), (fused, lerp)
    packed = []
    for sampling in ("select", True):
        td.config = dataclasses.replace(td.config, pallas_sampling=sampling)
        packed.append(td.decode_packed(w, planes, pos)[0])
    assert torch.equal(packed[0], packed[1])
    feats = [sample_from_planes(td.G.plane_axes, planes, pos[None], 1.0, 3, pallas_build=b)
             for b in ("select", True)]
    assert torch.equal(feats[0], feats[1])
    td.config = dataclasses.replace(td.config, pallas_sampling="select", fused_sampling=False,
                                    fused_lerp="dots")
    assert pallas_expand.brick_table_select.launches == before


def test_select_decoder_matches_jax(pair):
    """The port's pallas_sampling="select" decoder on the fused route (its
    default 'dots' lerp) against the JAX decoder with the same options:
    every row within 1e-3 (abs), pad columns not visible."""
    jd, td = pair["jd"], pair["td"]
    jdf = dataclasses.replace(jd, fused_sampling=True)
    jrows, _ = jdf.decode_project(pair["params"], jnp.asarray(pair["planes"]),
                                  jnp.asarray(pair["pos"]), pair["jcam"])
    td.config = dataclasses.replace(td.config, fused_sampling=True)
    try:
        rows, _ = td.decode_project(td.fold(), torch.tensor(pair["planes"]), pair["cam"],
                                    init_position=torch.tensor(pair["pos"]))
    finally:
        td.config = dataclasses.replace(td.config, fused_sampling=False)
    keep = [r for r in range(pallas_heads.NROWS) if r not in (14, 15)]
    rows, jrows = rows.numpy(), np.asarray(jrows)
    d = np.abs(rows[keep, :M] - jrows[keep, :M]).max()
    print(f"select decoder (fused, dots) vs JAX: max |d| {d:.3e}")
    assert d <= 1e-3
    assert not (rows[pallas_heads.PROJ_ROWS["visible"], M:] > 0.5).any()
