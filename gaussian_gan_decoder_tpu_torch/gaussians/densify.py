"""Adaptive density control at fixed capacity — port of gaussians/densify.py.

The reference (gaussian_model.py:353-534) concatenates and slices its
tensors, so N changes at every call. As in the JAX package, the scene here
lives at a fixed capacity with a validity mask:

  * prune    -> clear valid bits (opacity < eps, oversized screen/world)
  * clone    -> copy rows into invalid slots
  * split    -> write two resampled children into invalid slots, retire
                the parent
  * overflow -> candidates past the free slots are dropped, counted in the
                stats

The reference's optimizer surgery (:370-451) is reset_adam_state: the moments
of rewritten slots are zeroed in torch.optim.Adam's state. Also
get_expon_lr_func (ref general_utils.py:29-61) and reset_opacity (:306-309).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..splat.projection import build_rotation
from .model import GaussianScene, inverse_sigmoid


class DensifyStats(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor  # candidates lost to capacity


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1_000_000):
    """Log-linear learning-rate decay with an optional sine delay (ref
    general_utils.py:29-61) -> step -> learning rate (a float)."""

    def helper(step):
        step = float(step)
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        return delay * math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)

    return helper


def reset_opacity(scene: GaussianScene) -> GaussianScene:
    """(ref gaussian_model.py:306-309): activated opacity clamped to <= 0.01
    on the valid slots."""
    new = inverse_sigmoid(torch.clamp(torch.sigmoid(scene.opacity), max=0.01))
    return scene._replace(opacity=torch.where(scene.valid[:, None], new, scene.opacity))


def split_draws(key: torch.Generator, n: int, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """The standard normals (n, 3) of the two children of every slot (the
    JAX function's draws from the two halves of its split key), from the
    generator `key` on its own device."""
    z = torch.randn((2, n, 3), generator=key, device=key.device, dtype=dtype)
    return z[0], z[1]


def _write_slots(arr, slot_idx, values, active):
    """arr with values' rows written into rows slot_idx where active."""
    out = arr.clone()
    out[slot_idx[active]] = values[active]
    return out


def densify_and_prune(scene: GaussianScene, grad_accum: torch.Tensor, denom: torch.Tensor,
                      max_radii2d: torch.Tensor, key: torch.Generator,
                      max_grad: float = 0.0002, min_opacity: float = 0.005,
                      extent: float = 1.0, max_screen_size: Optional[float] = None,
                      percent_dense: float = 0.01) -> Tuple[GaussianScene, DensifyStats]:
    """One adaptive-density step at fixed capacity (ref :453-534), with the
    JAX function's slot allocation: the free slots (invalid after the
    prune) in index order, the clones' first, then two a split; a candidate
    past the free slots is dropped. grad_accum (N,) accumulated screen-space
    gradient norms, denom (N,) visibility counts, max_radii2d (N,) running
    screen radius; key, a torch.Generator on the scene's device, draws the
    split children (split_draws). -> (scene, stats); the inputs are not
    changed."""
    n = scene.num_points
    dev = scene.xyz.device
    grads = torch.nan_to_num(grad_accum / torch.clamp(denom, min=1e-12))
    max_scale = scene.get_scaling.amax(dim=1)

    # -- prune (ref :524-533) -----------------------------------------------
    prune = torch.sigmoid(scene.opacity[:, 0]) < min_opacity
    if max_screen_size is not None:
        prune = prune | (max_radii2d > max_screen_size) | (max_scale > 0.1 * extent)
    prune = prune & scene.valid
    valid = scene.valid & ~prune

    hit = (grads >= max_grad) & valid
    clone_sel = hit & (max_scale <= percent_dense * extent)
    split_sel = hit & (max_scale > percent_dense * extent)

    # -- free slots (invalid entries), clones first --------------------------
    free = ~valid
    free_idx = torch.full((n,), n, dtype=torch.long, device=dev)
    fi = torch.nonzero(free).flatten()
    free_idx[:fi.numel()] = fi
    n_free = fi.numel()
    clone_rank = torch.cumsum(clone_sel.long(), 0) - 1
    n_clone = clone_sel.long().sum()
    split_rank = torch.cumsum(split_sel.long(), 0) - 1

    def alloc(rank, base):
        slot_pos = base + rank
        ok = slot_pos < n_free
        return free_idx[torch.clamp(slot_pos, 0, n - 1)], ok

    c_slot, c_ok = alloc(clone_rank, 0)
    c_active = clone_sel & c_ok
    s_slot0, s_ok0 = alloc(split_rank * 2, n_clone)
    s_slot1, s_ok1 = alloc(split_rank * 2 + 1, n_clone)
    s_active0, s_active1 = split_sel & s_ok0, split_sel & s_ok1

    # -- split children, resampled inside the parent (ref :453-491) ---------
    stds = scene.get_scaling
    rots = build_rotation(scene.rotation)
    scaling = torch.log(stds / (0.8 * 2))
    children = [(torch.einsum("nij,nj->ni", rots, z * stds) + scene.xyz, scaling)
                for z in split_draws(key, n, scene.xyz.dtype)]

    fields = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
    new = {f: _write_slots(getattr(scene, f), c_slot, getattr(scene, f), c_active)
           for f in fields}
    valid = _write_slots(valid, c_slot, torch.ones_like(valid), c_active)
    for slot, active, (cx, cs) in ((s_slot0, s_active0, children[0]),
                                   (s_slot1, s_active1, children[1])):
        for f in fields:
            vals = cx if f == "xyz" else cs if f == "scaling" else getattr(scene, f)
            new[f] = _write_slots(new[f], slot, vals, active)
        valid = _write_slots(valid, slot, torch.ones_like(valid), active)
    # retire the split parents (ref prune_filter, :489-491)
    valid = valid & ~s_active0

    stats = DensifyStats(
        n_cloned=c_active.long().sum(), n_split=s_active0.long().sum(),
        n_pruned=prune.long().sum(),
        n_dropped=(clone_sel & ~c_ok).long().sum() + 2 * (split_sel & ~s_ok0).long().sum())
    return scene._replace(valid=valid, **new), stats


def reset_adam_state(optimizer: torch.optim.Adam, touched_mask: torch.Tensor) -> torch.optim.Adam:
    """Zero the Adam moments (exp_avg, exp_avg_sq) of the rows touched_mask
    (N,) marks, in every per-point parameter's state, in place: the
    reference's optimizer surgery (ref :370-451). The step counts stay, as
    the JAX function leaves optax's count. -> the optimizer."""
    n = touched_mask.shape[0]
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if p.ndim >= 1 and p.shape[0] == n:
                for name in ("exp_avg", "exp_avg_sq"):
                    if name in st:
                        st[name][touched_mask] = 0.0
    return optimizer
