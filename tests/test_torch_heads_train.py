"""Port parity for the f32 training head chain (K6 forward, K7 backward):
the plain PyTorch versions vs the JAX package's decode_heads_pallas and
jax.grad of decode_heads_pallas_diff (Pallas in interpret mode), for the
sequential_reversed chain with the exact GELU, M = 700 points (not a
multiple of any block). Tolerances: outputs max|d| <= 1e-5 of each
output's max; gradients max|d| <= 1e-4 of each parameter's largest
gradient (f32 matmuls summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.decoder.pallas_heads import decode_heads_pallas
from gaussian_gan_decoder_tpu.decoder.pallas_heads_vjp import (
    decode_heads_pallas_diff as jdecode_diff)
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu_torch.decoder.heads import CHAIN, DecoderHead
from gaussian_gan_decoder_tpu_torch.decoder.pallas_heads import (
    build_staging_f32, decode_heads_plain, pack_chain_f32)
from gaussian_gan_decoder_tpu_torch.decoder.pallas_heads_vjp import (
    decode_heads_bwd_plain, decode_heads_pallas_diff)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

M = 700


def _relerr(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


@pytest.fixture(scope="module")
def chain():
    """JAX head params of the sequential_reversed decoder, the port's heads
    with the same weights, and inputs from numpy."""
    jd = JDec(generator=JGen(z_dim=8, w_dim=8, without_sr=True), hidden_dim=128)
    params = jd.init(jax.random.PRNGKey(0))
    # scale the first layer so that later layers see GELU's curved region
    heads = {}
    for name, out_dim in CHAIN:
        h = DecoderHead(32 + 3 + sum(d for n, d in CHAIN[:[c for c, _ in CHAIN].index(name)]),
                        out_dim)
        with torch.no_grad():
            for i in range(4):
                p = params[name][f"fc{i}"]
                h.backbone[2 * i].weight.copy_(torch.tensor(np.asarray(p["weight"])))
                h.backbone[2 * i].bias.copy_(torch.tensor(np.asarray(p["bias"])))
        heads[name] = h
    rng = np.random.RandomState(0)
    feats = (rng.randn(M, 32) * 2.0).astype(np.float32)
    pos = ((rng.rand(M, 3) - 0.5) * 0.6).astype(np.float32)
    return params, heads, feats, pos


def test_heads_forward_matches_jax(chain):
    params, heads, feats, pos = chain
    ref = decode_heads_pallas({n: params[n] for n, _ in CHAIN}, CHAIN, jnp.asarray(feats),
                              jnp.asarray(pos), jnp.asarray(pos), -2.5, interpret=True,
                              return_packed=True, gelu="exact")[0]
    ref = np.asarray(ref)[:M]
    with torch.no_grad():
        cw = pack_chain_f32(heads, CHAIN, 3, -2.5, "exact")
        st = build_staging_f32(torch.tensor(feats), torch.tensor(pos), torch.tensor(pos))
        got = decode_heads_plain(st, cw).numpy()
    for c in range(14):
        assert _relerr(got[:, c], ref[:, c]) <= 1e-5, (c, _relerr(got[:, c], ref[:, c]))
    assert np.all(got[:, 14:] == 0)


def test_heads_grads_match_jax(chain):
    """Gradients of a random linear loss on the packed outputs w.r.t. every
    head parameter, the features, the conditioning and init_position."""
    params, heads, feats, pos = chain
    rng = np.random.RandomState(1)
    r = rng.randn(M, 16).astype(np.float32)
    cond = (pos * 1.5).astype(np.float32)

    def jloss(hp, f, c, i):
        out = jdecode_diff(hp, CHAIN, f, c, i, -2.5, False, "exact", 512, True)
        return jnp.sum(out[:M] * r)

    hp = {n: params[n] for n, _ in CHAIN}
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(hp, jnp.asarray(feats), jnp.asarray(cond),
                                             jnp.asarray(pos))
    tf, tc, ti = (torch.tensor(a, requires_grad=True) for a in (feats, cond, pos))
    for h in heads.values():
        h.zero_grad()
    out = decode_heads_pallas_diff(heads, CHAIN, tf, tc, ti, -2.5, gelu="exact")
    (out * torch.tensor(r)).sum().backward()
    for name, _ in CHAIN:
        for i in range(4):
            for k in ("weight", "bias"):
                got = getattr(heads[name].backbone[2 * i], k).grad.numpy()
                ref = np.asarray(jg[0][name][f"fc{i}"][k])
                assert _relerr(got, ref) <= 1e-4, (name, i, k, _relerr(got, ref))
    for got, ref, what in ((tf, jg[1], "feats"), (tc, jg[2], "cond"), (ti, jg[3], "init")):
        assert _relerr(got.grad.numpy(), ref) <= 1e-4, (what, _relerr(got.grad.numpy(), ref))


def test_heads_bwd_is_the_gradient_of_the_forward(chain):
    """The explicit K7 plain version equals torch autograd through the
    plain K6 forward, within 1e-5 of each gradient's max."""
    _, heads, feats, pos = chain
    cw = pack_chain_f32(heads, CHAIN, 3, -2.5, "exact")
    cw = cw._replace(**{n: getattr(cw, n).detach().requires_grad_(True) for n in
                        ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")})
    st = build_staging_f32(torch.tensor(feats), torch.tensor(pos),
                           torch.tensor(pos)).requires_grad_(True)
    out = decode_heads_plain(st, cw)
    dout = torch.tensor(np.random.RandomState(2).randn(M, 16).astype(np.float32))
    (out * dout).sum().backward()
    dst, grads = decode_heads_bwd_plain(st.detach(), out.detach(), dout,
                                        cw._replace(**{n: getattr(cw, n).detach() for n in
                                                       ("w1", "b1", "w2", "b2", "w3", "b3",
                                                        "w4", "b4")}))
    assert _relerr(dst.numpy(), st.grad.numpy()) <= 1e-5
    for n, g in zip(("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4"), grads):
        assert _relerr(g.numpy(), getattr(cw, n).grad.numpy()) <= 1e-5, n


def test_chain_packing_leaves_w1_zero_past_each_prefix(chain):
    """K6's layer 1 multiplies only the rows of w1 within each head's
    staging prefix (meta stage column): the packing must leave the rest
    zero, and refuses a head with inputs past its prefix."""
    _, heads, _, _ = chain
    cw = pack_chain_f32(heads, CHAIN, 3, -2.5, "exact")
    for h, (name, od, sc, oc) in enumerate(cw.chain):
        assert int(cw.meta[6 + h]) == sc
        assert bool((cw.w1[h, sc:] == 0).all())
        assert bool((cw.w1[h, :sc] != 0).any(dim=1).all())
    wide = dict(heads, color=DecoderHead(40, 3))
    with pytest.raises(ValueError, match="past its staging prefix"):
        pack_chain_f32(wide, CHAIN, 3, -2.5, "exact")
