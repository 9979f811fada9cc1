"""Port parity: the fused mapping kernel's plain version and the f32
MappingNetwork of gaussian_gan_decoder_tpu_torch vs the JAX package
(mapping_forward_pallas in interpret mode, MappingNetwork.apply)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.models.pallas_mapping import mapping_forward_pallas
from gaussian_gan_decoder_tpu.models.stylegan2 import MappingNetwork as JMappingNetwork
from gaussian_gan_decoder_tpu.port.torch_export import flatten_params
from gaussian_gan_decoder_tpu_torch.models.pallas_mapping import (
    fold_mapping, mapping_forward,
)
from gaussian_gan_decoder_tpu_torch.models.stylegan2 import MappingNetwork
from _torch_threads import torch_threads  # noqa: F401  (autouse)

Z, CD, W, NUM_WS = 32, 25, 32, 6


@pytest.fixture(scope="module")
def nets():
    jmn = JMappingNetwork(z_dim=Z, c_dim=CD, w_dim=W, num_ws=NUM_WS)
    params = jax.jit(jmn.init)(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    # non-trivial truncation target and biases
    params["w_avg"] = jnp.asarray(rng.randn(W).astype(np.float32))
    for k in params:
        if k.startswith("fc") or k == "embed":
            params[k]["bias"] = jnp.asarray(rng.randn(*params[k]["bias"].shape).astype(np.float32))
    tmn = MappingNetwork(Z, CD, W, NUM_WS)
    tmn.load_state_dict({k: torch.tensor(v) for k, v in flatten_params(params).items()},
                        strict=True)
    return jmn, params, tmn


def _inputs(seed, zero_c):
    rng = np.random.RandomState(seed)
    z = rng.randn(2, Z).astype(np.float32)
    c = np.zeros((2, CD), np.float32) if zero_c else rng.randn(2, CD).astype(np.float32)
    return z, c


@pytest.mark.parametrize("psi", [1.0, 0.6])
@pytest.mark.parametrize("zero_c", [True, False])
def test_fused_mapping_plain_matches_pallas(nets, psi, zero_c):
    """K1's plain version vs the TPU kernel (interpret): same bf16 rounding
    points, f32 sums in another order -> max|d| / mean|ref| <= 1e-2."""
    jmn, params, tmn = nets
    z, c = _inputs(2, zero_c)
    ref = np.asarray(mapping_forward_pallas(jmn, params, jnp.asarray(z), jnp.asarray(c),
                                            truncation_psi=psi, interpret=True))
    before = mapping_forward.launches
    out = mapping_forward(torch.tensor(z), torch.tensor(c), fold_mapping(tmn), psi).numpy()
    assert mapping_forward.launches == before   # CPU tensors never reach the kernel
    assert out.shape == ref.shape == (2, NUM_WS, W)
    err = np.abs(out - ref).max() / np.abs(ref).mean()
    print(f"K1 plain vs TPU kernel (psi {psi}, zero c {zero_c}): {err:.3e}")
    assert err <= 1e-2, err


@pytest.mark.parametrize("psi", [1.0, 0.6])
def test_mapping_network_f32_matches_jax(nets, psi):
    jmn, params, tmn = nets
    z, c = _inputs(3, False)
    ref = np.asarray(jmn.apply(params, jnp.asarray(z), jnp.asarray(c), truncation_psi=psi))
    out = tmn(torch.tensor(z), torch.tensor(c), truncation_psi=psi).detach().numpy()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    print(f"f32 MappingNetwork vs JAX (psi {psi}): {err:.3e}")
    assert err <= 1e-4, err
