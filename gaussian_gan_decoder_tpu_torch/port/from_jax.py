"""Load weights exported by the JAX package into the port.

The JAX side writes a flat, reference-named dict of numpy arrays
(gaussian_gan_decoder_tpu.port.torch_export.decoder_state_dict /
generator_state_from_params), or the same dict as a torch .pt file
(save_torch_state_dict). The port's modules carry those names, PanoHead's
t_mapping and bcg_synthesis included, so a dict loads with
load_state_dict(strict=True): any missing or unexpected key raises.
The JAX package's .pt writer stores a 0-d tensor (noise_strength) with
shape (1,) (np.ascontiguousarray): such an entry takes the module's 0-d
shape. The VGG16-LPIPS weights load under torchvision's names. This module
never imports jax.
"""
from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

State = Union[str, Mapping[str, np.ndarray]]


def _read(state: State) -> Mapping[str, np.ndarray]:
    if isinstance(state, str):
        if state.endswith(".npz"):
            return dict(np.load(state))
        return torch.load(state, map_location="cpu", weights_only=True)
    return state


def _tensors(state: Mapping, prefix: str = "", module=None):
    out = {k[len(prefix):]: torch.tensor(np.array(v, dtype=np.float32))
           for k, v in state.items() if k.startswith(prefix)}
    if module is not None:
        own = module.state_dict()
        for k, v in out.items():
            if k in own and own[k].ndim == 0 and tuple(v.shape) == (1,):
                out[k] = v.reshape(())
    return out


def load_decoder_state(decoder: torch.nn.Module, state: State) -> None:
    """Load a reference-named decoder state dict (heads, `G.` + generator;
    a mapping of arrays or the path of a .pt file) into a GaussianDecoder,
    strictly."""
    decoder.load_state_dict(_tensors(_read(state), module=decoder), strict=True)


def load_generator_state(generator: torch.nn.Module, state: State) -> None:
    """Load a reference-named generator state dict (backbone, decoder,
    torgb, superresolution, t_mapping, bcg_synthesis, as
    generator_state_from_params writes it) into a TriPlaneGenerator,
    strictly."""
    generator.load_state_dict(_tensors(_read(state), module=generator), strict=True)


def load_discriminator_state(discriminator: torch.nn.Module, state: State) -> None:
    """Load a reference-named discriminator state dict (b{res}, sb{res},
    mapping, b4: the JAX package's D param tree flattened with dots, or a
    GAN pickle's D) into a Discriminator, strictly."""
    discriminator.load_state_dict(_tensors(_read(state), module=discriminator), strict=True)


def load_vgg16_lpips_state(vgg: torch.nn.Module, state: State) -> None:
    """Load torchvision-named VGG16 weights (`features.{idx}.weight/bias`,
    the names VGG16LPIPS.load_torch_state_dict reads on the JAX side; an
    .npz, a .pt or a mapping) into the port's VGG16LPIPS, strictly."""
    vgg.load_state_dict(_tensors(_read(state)), strict=True)
