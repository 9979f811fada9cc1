"""Checkpoint / resume — port of train/checkpoint.py.

Three formats, as in the JAX package:
  1. a train state (`save` / `restore`): the decoder's parameters and
     buffers, the Adam moments and `step` (or a GAN train state's G, D,
     G_ema, both Adams, `step` and `cur_nimg`), in one torch.save file, plus a
     JSON snapshot of the dataclass configs beside it (<path>.config.json)
     that rebuilds every config (`load_configs`);
  2. a flat .npz of the decoder's parameters (`save_npz` / `load_npz`),
     under the JAX package's param-tree names (a/b/c), so the same weights
     give the same file on both sides;
  3. the 3DGS .ply -> gaussians/ply.py.

The JSON names the port's own dataclasses (modules of
gaussian_gan_decoder_tpu_torch). A JAX orbax checkpoint is not readable
without JAX; weights cross from the JAX package as the reference-named
decoder state dict (.pt), port/from_jax.load_decoder_state.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _config_to_json(obj) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__dataclass__": f"{type(obj).__module__}.{type(obj).__qualname__}",
            "fields": {f.name: _config_to_json(getattr(obj, f.name))
                       for f in dataclasses.fields(obj)},
        }
    if isinstance(obj, (list, tuple)):
        return [_config_to_json(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _config_to_json(v) for k, v in obj.items()}
    return obj


def _deep_tuple(v):
    return tuple(_deep_tuple(x) for x in v) if isinstance(v, list) else v


def _config_from_json(data):
    if isinstance(data, dict) and "__dataclass__" in data:
        module, _, qual = data["__dataclass__"].rpartition(".")
        if not module.startswith("gaussian_gan_decoder_tpu_torch."):
            raise ValueError(f"config class {data['__dataclass__']} is not the port's")
        cls = getattr(importlib.import_module(module), qual)
        fields = {k: _config_from_json(v) for k, v in data["fields"].items()}
        # tuples come back from JSON as lists: the config fields hold tuples
        # at every depth (rendering_kwargs pairs, bg_color), so convert
        # deeply, or the config is unhashable and unequal to the original
        return cls(**{k: _deep_tuple(v) for k, v in fields.items()})
    if isinstance(data, list):
        return [_config_from_json(x) for x in data]
    return data


def _to_cpu(obj):
    """Tensors of a nested state (dicts, lists, tuples) -> CPU copies."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _write(path: str, payload) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save(path: str, state, configs: Optional[Dict[str, Any]] = None) -> None:
    """Write a train state (train/distill.py TrainState: decoder weights,
    optimizer state, step; train/gan.py GANTrainState) or a mapping of
    state dicts to `path`
    (torch.save, CPU tensors), and the configs as JSON to
    <path>.config.json."""
    path = os.path.abspath(path)
    if hasattr(state, "g_opt"):
        payload = {"G": state.G.state_dict(), "D": state.D.state_dict(),
                   "G_ema": state.G_ema.state_dict(), "g_opt": state.g_opt.state_dict(),
                   "d_opt": state.d_opt.state_dict(), "step": int(state.step),
                   "cur_nimg": float(state.cur_nimg)}
    elif hasattr(state, "optimizer"):
        payload = {"decoder": state.decoder.state_dict(),
                   "optimizer": state.optimizer.state_dict(), "step": int(state.step)}
    else:
        payload = dict(state)
    _write(path, _to_cpu(payload))
    if configs is not None:
        with open(path + ".config.json", "w") as f:
            json.dump({k: _config_to_json(v) for k, v in configs.items()}, f, indent=2)


def restore(path: str, state=None):
    """Read what `save` wrote. Given a train state, load the weights
    (strictly) and the optimizer states into it in place, set its step and
    return it; otherwise return the stored mapping (CPU tensors)."""
    payload = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if state is None:
        return payload
    if hasattr(state, "g_opt"):
        for name in ("G", "D", "G_ema"):
            getattr(state, name).load_state_dict(payload[name], strict=True)
        state.g_opt.load_state_dict(payload["g_opt"])
        state.d_opt.load_state_dict(payload["d_opt"])
        state.step, state.cur_nimg = int(payload["step"]), float(payload["cur_nimg"])
        return state
    state.decoder.load_state_dict(payload["decoder"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def load_configs(path: str) -> Dict[str, Any]:
    with open(os.path.abspath(path) + ".config.json") as f:
        return {k: _config_from_json(v) for k, v in json.load(f).items()}


def tree_name(name: str) -> str:
    """A reference state-dict name -> the JAX package's param-tree path:
    `{head}_decoder.backbone.{2i}.p` -> `{head}/fc{i}/p`, the OSG decoder's
    `decoder.net.{0,2}` -> `decoder/fc{0,1}` (the inverse of JAX
    port/torch_export's renames), dots -> slashes."""
    parts = name.split(".")
    if len(parts) == 4 and parts[0].endswith("_decoder") and parts[1] == "backbone":
        return "/".join([parts[0].removesuffix("_decoder"), f"fc{int(parts[2]) // 2}",
                         parts[3]])
    out, i = [], 0
    while i < len(parts):
        if parts[i] == "decoder" and i + 2 < len(parts) and parts[i + 1] == "net":
            out += ["decoder", f"fc{int(parts[i + 2]) // 2}"]
            i += 3
        else:
            out.append(parts[i])
            i += 1
    return "/".join(out)


def save_npz(path: str, params: Mapping[str, Any]) -> None:
    """Flat `a/b/c -> array` export of a reference-named state dict (a
    module's state_dict(), or a mapping of arrays): the JAX package's
    save_npz layout (the reference's decoder{i}.pt state dict, as .npz)."""
    flat = {tree_name(k): (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in params.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    return dict(np.load(path))
