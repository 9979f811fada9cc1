"""Port parity of K9's 'dots' lerp (the JAX decoder's default fused_lerp)
against the JAX package's decode_project_pallas_fused(lerp_mode="dots") in
interpret mode, at the JAX tests' small sizes (M = 300 points spread past
the box, block 128, a 16^2 tri-grid of depth 3 or a 32^2 EG3D tri-plane,
random heads drawn with numpy):

- the plain 'dots' lerp against the JAX kernel body's own two bf16 products
  (the corner expander and the segment sum, jnp on the CPU) on the JAX fused
  inputs: 8 int8 corners and 4 bf16 corners, within 1e-6 of the features'
  scale (only the order of the f32 sums differs), and away from 'bcast';
- the fused decode's plain version in the four forms (8 int8 / 4 bf16
  corners, bf16 / f32 chain): the bf16 chain's rows within 1e-3 (abs) on
  every row, the f32 chain's within 1e-4 of each row's scale (the f32
  tails' limits; 'dots' keeps its bf16 products at f32 heads, as JAX
  does);
- the decoder's default fused route (fused_lerp 'dots') against the JAX
  decoder's default, on D-par (parallel, xyz embedding, f32 heads)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.pallas_heads import decode_project_pallas_fused
from gaussian_gan_decoder_tpu.neuralfield import renderer as jrenderer
from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
from test_torch_decoder_tails import (  # noqa: F401  (inputs: the fixture)
    BLOCK, M, MPAD, _hold_f32, decoder_pair, inputs)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

C = 32
# (variant, tri-grid depth, JAX brick dtype)
FORMS = {"panohead": (3, jnp.int8), "eg3d": (1, jnp.bfloat16)}


def _jax_fused(inputs, variant):
    depth, brick = FORMS[variant]
    planes = (inputs["planes"] if depth > 1 else
              np.random.RandomState(22).randn(1, 3, 32, 32, 32).astype(np.float32))
    jrows, jwts, jsmats, K = jrenderer.sample_fused_inputs(
        jrenderer.generate_planes(variant), jnp.asarray(planes),
        jnp.asarray(inputs["pos"])[None], box_warp=1.0, triplane_depth=depth,
        brick_dtype=brick, pallas_build=depth > 1, pad_to=MPAD)
    rows_in = [torch.tensor(np.asarray(r.astype(jnp.float32))).to(ph.FUSED_FORMS[K])
               for r in jrows]
    # the segment matrices' entries: the folded scale JAX's 'dots' rounds
    scale = np.ascontiguousarray(np.asarray(jsmats)[:, np.arange(C), np.arange(C)])
    return jrows, jwts, jsmats, K, rows_in, torch.tensor(np.asarray(jwts)), torch.tensor(scale)


def _jax_dots_features(jrows, jwts, jsmats, K):
    """The JAX kernel's 'dots' lerp (pallas_heads.py:454-471) as jnp on the
    CPU: (Mpad, C) f32."""
    wT = jnp.transpose(jwts)
    lane_g = jnp.arange(K * C)[None, :] // C
    expander = (lane_g == jnp.arange(K)[:, None]).astype(jnp.bfloat16)
    acc = jnp.zeros((wT.shape[0], C), jnp.float32)
    for p, r in enumerate(jrows):
        w8 = wT[:, p * K:(p + 1) * K].astype(jnp.bfloat16)
        wrow = jnp.dot(w8, expander, preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        prod = r.astype(jnp.bfloat16) * wrow
        acc = acc + jnp.dot(prod, jsmats[p].astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
    return np.asarray(acc)


def test_dots_lerp_matches_jax_kernel_body(inputs):
    """fused_features_plain(lerp='dots') against the JAX kernel's two bf16
    products on the same inputs, 8 int8 and 4 bf16 corners; the 'bcast'
    lerp differs from it (by the bf16 roundings)."""
    for variant in FORMS:
        jrows, jwts, jsmats, K, rows_in, wts, scale = _jax_fused(inputs, variant)
        ref = _jax_dots_features(jrows, jwts, jsmats, K)
        got = ph.fused_features_plain(rows_in, wts, scale, "dots").numpy()
        bcast = ph.fused_features_plain(rows_in, wts, scale, "bcast").numpy()
        tol = np.abs(ref).max()
        err, gap = np.abs(got - ref).max() / tol, np.abs(bcast - ref).max() / tol
        print(f"{variant} (K {K}): dots vs the JAX body {err:.3e}, bcast vs it {gap:.3e}")
        assert err <= 1e-6 and gap > 1e-4, (variant, err, gap)
        assert not got[M:].any()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_fused_dots_matches_jax(inputs, dtype):
    """The fused decode's plain 'dots' form against the JAX kernel's, on
    the JAX side's own fused inputs, 8 int8 corners and 4 bf16 corners: the
    flagship chain (sequential_reversed, "poly") at bf16, D-par (parallel,
    xyz embedding, exact GELU) at f32."""
    bf16 = dtype == "bf16"
    decoder = ("sequential_reversed", False, "poly") if bf16 else ("parallel", True, "exact")
    jd, hp, chain, td = decoder_pair(*decoder, seed=40, heads_bf16=bf16)
    cw = td.fold().chain
    pos = inputs["pos"]
    jpos, tpos = jnp.asarray(pos), torch.tensor(pos)
    for variant in FORMS:
        jrows, jwts, jsmats, K, rows_in, wts, scale = _jax_fused(inputs, variant)
        ref, _ = decode_project_pallas_fused(
            hp, chain, jrows, jwts, jsmats, K, jd.embedder(jpos) if decoder[1] else jpos, jpos,
            jd.scale_offset, cam=inputs["jcam"], n_points=M, parallel=decoder[0] == "parallel",
            compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, block=BLOCK, interpret=True,
            gelu=decoder[2], lerp_mode="dots")
        aux, _ = ph.build_brick_staging(torch.zeros(M, C), td.cond0(tpos), tpos, block=BLOCK,
                                        dtype=torch.bfloat16 if bf16 else torch.float32)
        fn = ph.decode_project_fused
        before = (fn.launches_dots, fn.launches_dots_f32)
        rows = ph.decode_project_fused(cw, aux, rows_in, wts, scale, inputs["cam"], M,
                                       lerp="dots").numpy()
        assert before == (fn.launches_dots, fn.launches_dots_f32)
        ref = np.asarray(ref)
        label = f"K9-dots plain vs JAX ({variant}, K {K}, {dtype} chain)"
        if bf16:
            keep = [r for r in range(ph.NROWS) if r not in (14, 15)]
            d = np.abs(rows[keep, :M] - ref[keep, :M]).max()
            print(f"{label}: max |d| {d:.3e}")
            assert d <= 1e-3 and np.all(rows[14:16] == 0.0)
            assert not (rows[ph.PROJ_ROWS["visible"], M:] > 0.5).any()
        else:
            _hold_f32(rows, ref, label)


def test_decoder_default_fused_route_matches_jax(inputs):
    """GaussianDecoder's default fused_lerp is 'dots', as JAX's; D-par's
    fused route (int8 table, f32 heads) against the JAX decoder's default
    fused route, within the f32 tails' limits."""
    jd, hp, _, td = decoder_pair("parallel", True, "exact", seed=41)
    assert td.fused_lerp == jd.fused_lerp == "dots"
    jdf = dataclasses.replace(jd, fused_sampling=True, pallas_heads=True, pallas_sampling=True)
    jrows, _ = jdf.decode_project(hp, jnp.asarray(inputs["planes"]),
                                  jnp.asarray(inputs["pos"]), inputs["jcam"])
    td.config = dataclasses.replace(td.config, fused_sampling=True, pallas_heads=True,
                                    pallas_sampling=True)
    rows, _ = td.decode_project(td.fold(), torch.tensor(inputs["planes"]), inputs["cam"],
                                init_position=torch.tensor(inputs["pos"]))
    jrows = np.asarray(jrows)
    assert rows.shape[1] == jrows.shape[1] == 1024
    _hold_f32(rows.numpy(), jrows, "D-par decoder fused route (dots) vs JAX's")
