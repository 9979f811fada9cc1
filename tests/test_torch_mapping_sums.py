"""K1's plain version takes its sums in float64: the result does not depend
on the order of any sum. Two checks, on the CPU, at a narrow width and at
the flagship's (z 512, c 25, w 512, 8 layers) with a random camera:

- permuting the k axis of every layer (weights and activations alike: the
  z entries, the camera entries, the embed's and every hidden layer's
  output columns) gives the same bits;
- the output equals a numpy evaluation of the same arithmetic: each sum in
  float64 rounded to f32, the norms' 1/sqrt in float64 rounded to f32, the
  rest in f32 at the same points.
"""
import numpy as np
import torch

from gaussian_gan_decoder_tpu_torch.models.pallas_mapping import (
    FoldedMapping, fold_mapping, mapping_forward_plain)
from gaussian_gan_decoder_tpu_torch.models.stylegan2 import MappingNetwork
from _torch_threads import torch_threads  # noqa: F401  (autouse)

# (z_dim, c_dim, width, batch, truncation psi)
CASES = ((64, 25, 96, 3, 0.7), (512, 25, 512, 2, 0.7))


def _case(z_dim, c_dim, width, batch, seed):
    g = torch.Generator().manual_seed(seed)
    mn = MappingNetwork(z_dim, c_dim, width, num_ws=4, generator=g)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        mn.w_avg.copy_(torch.tensor(rng.randn(width).astype(np.float32)))
        for i in range(mn.num_layers):
            getattr(mn, f"fc{i}").bias.copy_(torch.tensor(
                rng.randn(width).astype(np.float32)))
    z = torch.tensor(rng.randn(batch, z_dim).astype(np.float32))
    c = torch.tensor(rng.randn(batch, c_dim).astype(np.float32))
    return fold_mapping(mn), z, c


def _permuted(fm, z, c, rng):
    """The same function with the k axis of every sum permuted."""
    Z, W = z.shape[1], fm.w0.shape[1]
    pz, pc, py = (torch.tensor(rng.permutation(n)) for n in (Z, c.shape[1], W))
    w0 = fm.w0.clone()
    w0[:Z] = fm.w0[:Z][pz]
    w0[Z:] = fm.w0[Z:][py]
    outs = [torch.tensor(rng.permutation(W)) for _ in range(fm.wr.shape[0])]
    # layer l's output columns (and bias) by outs[l]; layer l + 1's rows alike
    w0, b0 = w0[:, outs[0]], fm.b0[outs[0]]
    wr, br = fm.wr.clone(), fm.br.clone()
    for k in range(fm.wr.shape[0]):
        w = fm.wr[k][outs[k]]
        if k + 1 < len(outs):
            wr[k], br[k] = w[:, outs[k + 1]], fm.br[k][outs[k + 1]]
        else:
            wr[k] = w
    fp = FoldedMapping(we=fm.we[pc][:, py], be=fm.be[py], w0=w0, b0=b0, wr=wr, br=br,
                       w_avg=fm.w_avg, num_ws=fm.num_ws)
    return fp, z[:, pz], c[:, pc]


def _bf16r(a):
    """f32 -> the nearest bf16 (ties to even), as f32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _numpy_mapping(fm, z, c, psi):
    f32 = np.float32
    we, be, w0, b0, wr, br, w_avg = (t.float().numpy() for t in (
        fm.we, fm.be, fm.w0, fm.b0, fm.wr, fm.br, fm.w_avg))

    def norm(x):
        ss = (x.astype(np.float64) ** 2).sum(1, keepdims=True).astype(f32)
        m = ss / f32(x.shape[1]) + f32(1e-8)
        return x * (1.0 / np.sqrt(m.astype(np.float64))).astype(f32)

    def dot(x, w):
        return (_bf16r(x).astype(np.float64) @ w.astype(np.float64)).astype(f32)

    def lrelu(v):
        return (np.maximum(v, f32(0)) + f32(0.2) * np.minimum(v, f32(0))) * f32(np.sqrt(2.0))

    x = np.concatenate([norm(z.numpy()), norm(dot(c.numpy(), we) + be)], axis=1)
    x = lrelu(dot(x, w0) + b0)
    for k in range(wr.shape[0]):
        x = lrelu(dot(x, wr[k]) + br[k])
    return w_avg + (x - w_avg) * f32(psi)


def test_plain_mapping_ignores_the_order_of_its_sums():
    for i, (z_dim, c_dim, width, batch, psi) in enumerate(CASES):
        fm, z, c = _case(z_dim, c_dim, width, batch, i)
        out = mapping_forward_plain(z, c, fm, psi)
        fp, zp, cp = _permuted(fm, z, c, np.random.RandomState(10 + i))
        again = mapping_forward_plain(zp, cp, fp, psi)
        assert torch.equal(out, again), float((out - again).abs().max())


def test_plain_mapping_equals_float64_sums():
    for i, (z_dim, c_dim, width, batch, psi) in enumerate(CASES):
        fm, z, c = _case(z_dim, c_dim, width, batch, 20 + i)
        out = mapping_forward_plain(z, c, fm, psi).numpy()
        ref = _numpy_mapping(fm, z, c, psi)
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(out, ref)
