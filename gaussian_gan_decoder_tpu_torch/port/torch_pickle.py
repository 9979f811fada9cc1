"""Import reference checkpoints (.pkl) — port of port/torch_pickle.py: the
generator of a GAN snapshot and a decoder snapshot, for --network_pkl.

The reference's snapshots are pickles of torch modules wrapped by
torch_utils.persistence (source-embedding classes, persistence.py:37-253):
each module reduces to `_reconstruct_persistent_obj(meta)` whose meta
carries {type, class_name, module_src, state (the module __dict__ with
_parameters / _buffers / _modules), init_args, init_kwargs}. The embedded
source is never run: a custom Unpickler turns the reconstructor into an
inert PersistentStub holding that state, and maps every other
reference-internal symbol to an inert dict; tensors deserialise through
torch.

From the stubs come reference-named flat state dicts (extract_state, the
static FIR filters dropped: the port's modules derive them from their
geometry) and the port's configs (generator_config_from_pickle,
discriminator_config_from_pickle); the state dicts load strictly through
port/from_jax's loaders. A full GAN training snapshot ({G, D, G_ema,
augment_pipe}) loads through load_gan_snapshot_pkl. The TensorFlow
pickles of port/tf_legacy.py are ROADMAP queue A item A8.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..decoder.heads import CHAIN, HIDDEN, GaussianDecoder, GaussianDecoderConfig
from ..models.discriminator import DiscriminatorConfig
from ..models.triplane import TriPlaneGenerator, TriPlaneGeneratorConfig, _frozen_items
from .from_jax import load_decoder_state, load_generator_state

# static FIR constants: config, not weights, in both packages
_FILTER_SUFFIXES = ("resample_filter", "up_filter", "down_filter")


class PersistentStub:
    """Inert stand-in for a persistence-wrapped torch module."""

    def __init__(self, meta):
        self.meta = meta
        self.class_name = meta.get("class_name", "?")
        self.state = meta.get("state", {})
        # persistence stores the constructor's arguments on the instance
        # (state['_init_args']), not in the meta dict
        # (ref torch_utils/persistence.py:107-124)
        self.init_args = self.state.get("_init_args", meta.get("init_args", ()))
        self.init_kwargs = dict(self.state.get("_init_kwargs", meta.get("init_kwargs", {})))

    def __repr__(self):
        return f"PersistentStub({self.class_name})"


def _reconstruct_stub(meta):
    return PersistentStub(meta)


class _EasyDict(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self[k] = v


class _RefUnpickler(pickle.Unpickler):
    """Resolves reference-internal classes to inert stand-ins; torch and
    numpy resolve normally."""

    def find_class(self, module, name):
        if name == "_reconstruct_persistent_obj" and "persistence" in module:
            return _reconstruct_stub
        if name == "EasyDict":
            return _EasyDict
        if module.startswith(("dnnlib", "torch_utils", "training", "main", "camera_utils")):
            return _EasyDict
        return super().find_class(module, name)


def load_reference_pickle(path_or_file) -> Any:
    """Unpickle a reference snapshot without its codebase."""
    if hasattr(path_or_file, "read"):
        return _RefUnpickler(path_or_file).load()
    with open(path_or_file, "rb") as f:
        return _RefUnpickler(f).load()


def extract_state(obj, prefix: str = "", out: Optional[Dict[str, np.ndarray]] = None
                  ) -> Dict[str, np.ndarray]:
    """Walk stubs / torch modules -> flat {dotted_name: float32 ndarray},
    the static filters dropped."""
    if out is None:
        out = {}
    state = None
    if isinstance(obj, PersistentStub):
        state = obj.state
    else:
        # a live torch module, or a plainly pickled (not persistent)
        # reference module that the unpickler stood in as a dict (eg3d's
        # OSGDecoder): its _parameters sit in the instance __dict__
        d = getattr(obj, "__dict__", None)
        if isinstance(d, dict) and ("_parameters" in d or "_modules" in d):
            state = d
    if state is None:
        return out
    for bag in ("_parameters", "_buffers"):
        for name, v in (state.get(bag) or {}).items():
            if torch.is_tensor(v) and not name.endswith(_FILTER_SUFFIXES):
                out[prefix + name] = v.detach().to(torch.float32).cpu().numpy()
    for name, sub in (state.get("_modules") or {}).items():
        if sub is not None:
            extract_state(sub, prefix + name + ".", out)
    return out


def generator_config_from_pickle(g_stub: PersistentStub, variant: Optional[str] = None
                                 ) -> TriPlaneGeneratorConfig:
    """The port's generator config from the pickled constructor arguments
    (ref load_network.py:12-18): a PanoHead tri-grid, or an EG3D tri-plane
    (rendering_kwargs without a triplane_depth above 1, or variant='eg3d').
    EG3D's OSGDecoder is not a persistent class upstream: it pickles as a
    plain torch module, which extract_state reads as well."""
    kw = dict(g_stub.init_kwargs)
    names = ["z_dim", "c_dim", "w_dim", "img_resolution", "img_channels"]
    pos = dict(zip(names, g_stub.init_args))
    rendering_kwargs = dict(kw.get("rendering_kwargs", {}))
    if variant is None:
        variant = "panohead" if rendering_kwargs.get("triplane_depth", 1) > 1 else "eg3d"
    if variant not in ("panohead", "eg3d"):
        raise ValueError(f"unknown generator variant {variant!r}")

    def get(k, default):
        return pos.get(k, kw.get(k, default))

    return TriPlaneGeneratorConfig(
        z_dim=get("z_dim", 512), c_dim=get("c_dim", 25), w_dim=get("w_dim", 512),
        img_resolution=get("img_resolution", 512), img_channels=get("img_channels", 3),
        variant=variant, channel_base=kw.get("channel_base", 32768),
        channel_max=kw.get("channel_max", 512), num_fp16_res=kw.get("num_fp16_res", 0),
        sr_num_fp16_res=kw.get("sr_num_fp16_res", 0), conv_clamp=kw.get("conv_clamp"),
        mapping_kwargs=_frozen_items(kw.get("mapping_kwargs", {})),
        rendering_kwargs=_frozen_items(rendering_kwargs))


def load_generator_pkl(path, variant: Optional[str] = None, key: str = "G_ema",
                       device="cuda") -> Tuple[TriPlaneGenerator, Dict[str, np.ndarray]]:
    """Reference GAN snapshot -> (TriPlaneGenerator with its weights on
    `device`, the reference-named state dict), as load_from_pkl_new_G."""
    data = load_reference_pickle(path)
    g = data[key] if isinstance(data, dict) else data
    if not isinstance(g, PersistentStub):
        raise ValueError(f"{key} of the pickle is a {type(g).__name__}, not a persistent module")
    gen = TriPlaneGenerator.from_config(generator_config_from_pickle(g, variant), device=device)
    state = extract_state(g)
    load_generator_state(gen, state)
    return gen, state


_DECODER_TYPES = {"SequentialDecoderReverse": "sequential_reversed",
                  "SequentialDecoder": "sequential", "ParallelDecoder": "parallel"}
_HEAD_NAMES = tuple(name for name, _ in CHAIN)


def _is_head(name: str) -> bool:
    """`{head}_decoder.backbone.{idx}.{weight,bias}` (ref
    main/decoder_models/base_decoder.py:11-19)."""
    parts = name.split(".")
    return (len(parts) == 4 and parts[1] == "backbone"
            and parts[0].removesuffix("_decoder") in _HEAD_NAMES)


def load_decoder_pkl(path_or_file, key: str = "decoder", device="cuda"
                     ) -> Tuple[GaussianDecoder, Dict[str, np.ndarray]]:
    """Reference decoder snapshot (main/load_decoder.py:28-34: the 'decoder'
    entry, a persistence-wrapped decoder embedding its fine-tuned G) ->
    (GaussianDecoder with its weights on `device`, the reference-named
    state dict: heads + `G.` + generator). Every decoder class of the
    reference loads (SequentialDecoderReverse, SequentialDecoder,
    ParallelDecoder), at its hidden width and with or without the xyz
    embedding; a pickle that records no use_xyz_embedding reads as True,
    the reference constructor's default, as the JAX loader reads it. The
    heads keep the reference's exact GELU and the JAX decoder's default
    options (f32 heads, the plain chain in apply); the weights load
    strictly."""
    data = (path_or_file if isinstance(path_or_file, (dict, PersistentStub))
            else load_reference_pickle(path_or_file))
    d = data[key] if isinstance(data, dict) else data
    if not isinstance(d, PersistentStub):
        raise ValueError(f"{key} of the pickle is a {type(d).__name__}, not a persistent module")
    g_stub = (d.state.get("_modules") or {}).get("G")
    if not isinstance(g_stub, PersistentStub):
        raise ValueError("the decoder snapshot has no G module")
    kw = dict(d.init_kwargs)
    decoder_type = _DECODER_TYPES.get(d.class_name.rsplit(".", 1)[-1])
    if decoder_type is None:
        raise ValueError(f"unknown decoder class {d.class_name}: expected one of "
                         f"{sorted(_DECODER_TYPES)}")
    hidden = int(d.state.get("hidden_dim", kw.get("hidden_dim", HIDDEN)))
    xyz_embedding = bool(d.state.get("use_xyz_embedding", kw.get("use_xyz_embedding", True)))
    cfg = GaussianDecoderConfig(generator_config_from_pickle(g_stub), gelu="exact",
                                decoder_type=decoder_type, hidden_dim=hidden,
                                use_xyz_embedding=xyz_embedding)
    decoder = GaussianDecoder.from_config(cfg, device=device)
    state = {k: v for k, v in extract_state(d).items() if k.startswith("G.") or _is_head(k)}
    load_decoder_state(decoder, state)
    return decoder, state


# -- discriminators and full GAN snapshots (ref training_loop.py:430-444
# pickles {'G', 'D', 'G_ema', 'augment_pipe'}; :160-166 resumes from one)

_DISC_MODES = {"SingleDiscriminator": "single", "DualDiscriminator": "dual",
               "MaskDualDiscriminator": "mask_dual"}


def discriminator_config_from_pickle(d_stub: PersistentStub) -> DiscriminatorConfig:
    """The port's discriminator config from the pickled constructor
    arguments (ref dual_discriminator.py; positional c_dim, img_resolution,
    img_channels[, seg_resolution, seg_channels])."""
    cls = d_stub.class_name.rsplit(".", 1)[-1]
    mode = _DISC_MODES.get(cls)
    if mode is None:
        raise ValueError(f"unsupported discriminator class {cls}")
    kw = dict(d_stub.init_kwargs)
    names = ["c_dim", "img_resolution", "img_channels"]
    if mode == "mask_dual":
        names += ["seg_resolution", "seg_channels"]
    pos = dict(zip(names, d_stub.init_args))

    def get(k, default):
        return pos.get(k, kw.get(k, default))

    ep = dict(kw.get("epilogue_kwargs", {}))
    return DiscriminatorConfig(
        c_dim=get("c_dim", 25), img_resolution=get("img_resolution", 512),
        img_channels=get("img_channels", 3), mode=mode,
        architecture=kw.get("architecture", "resnet"),
        channel_base=kw.get("channel_base", 32768), channel_max=kw.get("channel_max", 512),
        num_fp16_res=kw.get("num_fp16_res", 4), conv_clamp=kw.get("conv_clamp", 256),
        cmap_dim=kw.get("cmap_dim"), disc_c_noise=float(kw.get("disc_c_noise", 0.0)),
        seg_resolution=get("seg_resolution", 64), seg_channels=get("seg_channels", 1),
        mbstd_group_size=ep.get("mbstd_group_size", 4))


def discriminator_params_from_state(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A pickled discriminator's flat state (extract_state) -> the state
    dict the port's Discriminator loads: its names (b{res}, sb{res},
    mapping, b4) are the reference module tree's, so this is the same dict
    with the static filters left out."""
    return {k: v for k, v in flat.items() if not k.endswith(_FILTER_SUFFIXES)}


def load_gan_snapshot_pkl(path_or_file) -> Dict[str, Any]:
    """A reference GAN training snapshot -> {'G': TriPlaneGeneratorConfig,
    'g_params', 'g_ema': reference-named state dicts, 'D':
    DiscriminatorConfig or None, 'd_params': state dict or None}, as the
    JAX loader returns them (G_ema's weights stand for G's when the
    snapshot has no G, and G's for G_ema's). Accepts a path, a file or an
    already-unpickled snapshot dict."""
    data = (path_or_file if isinstance(path_or_file, dict)
            else load_reference_pickle(path_or_file))
    if not isinstance(data, dict):
        raise ValueError(f"a GAN snapshot is a dict, not a {type(data).__name__}")
    g = data.get("G") or data.get("G_ema")
    if not isinstance(g, PersistentStub):
        raise ValueError("the snapshot has no generator")
    out: Dict[str, Any] = {"G": generator_config_from_pickle(g),
                           "g_params": extract_state(g)}
    ema = data.get("G_ema")
    out["g_ema"] = extract_state(ema) if isinstance(ema, PersistentStub) else out["g_params"]
    d = data.get("D")
    if isinstance(d, PersistentStub):
        out["D"] = discriminator_config_from_pickle(d)
        out["d_params"] = discriminator_params_from_state(extract_state(d))
    else:
        out["D"], out["d_params"] = None, None
    return out
