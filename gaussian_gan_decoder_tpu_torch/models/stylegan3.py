"""StyleGAN3 alias-free generator — port of models/stylegan3.py (the
reference's training/networks_stylegan3.py): the SynthesisLayer (:255-396,
a modulated 1x1 / 3x3 conv, then ops/filtered_lrelu.py's upsample -> leaky
ReLU -> downsample with Kaiser-windowed sinc filters designed from the
layer's cutoff and stopband, :303-324), the Fourier-feature SynthesisInput
(:171-250), the SynthesisNetwork whose layers follow a geometric cutoff /
stopband progression (:400-487) and the Generator (:491-515), on the
port's ops (bias_act, upfirdn2d, modulated_conv2d) in plain PyTorch.

Parameter names are the reference's (`synthesis.L{i}_{size}_{channels}.
{affine.*, weight, bias, magnitude_ema}`, `synthesis.input.{weight,
affine.*, transform, freqs, phases}`, `mapping.*`), so the JAX package's
param tree (port/from_jax.load_param_tree) and a reference state dict load
strictly. The FIR filters are derived from the layer geometry and never
loaded: they are non-persistent buffers, and the pickle importer drops a
checkpoint's up_filter / down_filter (port/torch_pickle.py). The
demodulation pre-normalisation of the reference's SG3 modulated conv
(:42-45) cancels exactly in f32, so the shared modulated conv is used.
Blocks may run in bf16 (`use_bf16`, the reference's fp16 layers), off by
default. The equivariance metrics (metrics/equivariance.py) pass a user
transform to `synthesis(ws, transform=...)`.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import filtered_lrelu, modulated_conv2d
from .stylegan2 import FullyConnectedLayer, MappingNetwork, _randn


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float,
                          radial: bool = False) -> Optional[np.ndarray]:
    """Kaiser-windowed sinc (ref networks_stylegan3.py:41-64); radial: the
    radially symmetric jinc with a separable Kaiser window (ref :378-386)."""
    import scipy.signal
    import scipy.special

    if numtaps == 1:
        return None
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return np.asarray(f, np.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(r == 0, float(cutoff),
                     scipy.special.j1(2 * cutoff * (math.pi * r)) / (math.pi * r))
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f = f * np.outer(w, w)
    f = f / f.sum()
    return np.asarray(f, np.float32)


def _filter_buffer(module: nn.Module, name: str, f: Optional[np.ndarray], device) -> None:
    module.register_buffer(name, None if f is None else torch.tensor(f, device=device),
                           persistent=False)


class SynthesisLayer3(nn.Module):
    def __init__(self, w_dim, in_channels, out_channels, in_size, out_size, in_sampling_rate,
                 out_sampling_rate, in_cutoff, out_cutoff, in_half_width, out_half_width,
                 conv_kernel=3, lrelu_upsampling=2, filter_size=6, use_radial_filters=False,
                 conv_clamp: Optional[float] = 256.0, is_torgb=False, generator=None,
                 device=None):
        super().__init__()
        self.in_channels, self.conv_kernel = in_channels, conv_kernel
        self.conv_clamp, self.is_torgb = conv_clamp, is_torgb
        tmp_rate = max(in_sampling_rate, out_sampling_rate) * (1 if is_torgb else
                                                               lrelu_upsampling)
        self.up_factor = int(np.rint(tmp_rate / in_sampling_rate))
        self.down_factor = int(np.rint(tmp_rate / out_sampling_rate))
        up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        down_taps = (filter_size * self.down_factor if self.down_factor > 1 and not is_torgb
                     else 1)
        fu = design_lowpass_filter(up_taps, in_cutoff, in_half_width * 2, tmp_rate)
        fd = design_lowpass_filter(down_taps, out_cutoff, out_half_width * 2, tmp_rate,
                                   radial=use_radial_filters)
        _filter_buffer(self, "up_filter", fu, device)
        _filter_buffer(self, "down_filter", fd, device)
        # the total filtered_lrelu padding that gives exactly out_size (ref
        # :323-329): the conv pads k - 1, the lo / hi split per Appendix C.3
        fu_taps = 1 if fu is None else fu.shape[0]
        fd_taps = 1 if fd is None else fd.shape[0]
        pad_total = (out_size - 1) * self.down_factor + 1
        pad_total -= (in_size + conv_kernel - 1) * self.up_factor
        pad_total += fu_taps + fd_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [pad_lo, pad_hi, pad_lo, pad_hi]
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0,
                                          generator=generator, device=device)
        self.weight = nn.Parameter(_randn((out_channels, in_channels, conv_kernel, conv_kernel),
                                          generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self.register_buffer("magnitude_ema", torch.ones((), device=device))

    def forward(self, x, w):
        styles = self.affine(w)
        if self.is_torgb:
            styles = styles * (1 / math.sqrt(self.in_channels * self.conv_kernel ** 2))
        # input magnitude normalisation with the frozen EMA (ref :336-341)
        input_gain = torch.rsqrt(self.magnitude_ema)
        x = modulated_conv2d(x * input_gain.to(x.dtype), self.weight, styles,
                             padding=self.conv_kernel - 1, demodulate=not self.is_torgb)
        return filtered_lrelu(x, self.up_filter, self.down_filter, self.bias.to(x.dtype),
                              up=self.up_factor, down=self.down_factor, padding=self.padding,
                              gain=1.0 if self.is_torgb else math.sqrt(2),
                              slope=1.0 if self.is_torgb else 0.2, clamp=self.conv_clamp)


class SynthesisInput3(nn.Module):
    """Fourier features on a learned, affinely transformed frequency basis
    (ref networks_stylegan3.py:171-250)."""

    def __init__(self, w_dim, channels, size, sampling_rate, bandwidth, generator=None,
                 device=None):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        # t = (r_c, r_s, t_x, t_y), the identity rotation at init (ref :195)
        self.affine = FullyConnectedLayer(w_dim, 4, generator=generator, device=device)
        with torch.no_grad():
            self.affine.weight.zero_()
            self.affine.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        # frequencies uniform in a disc of radius bandwidth (ref :186-191)
        freqs = _randn((channels, 2), generator, device)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp() ** 0.25) * bandwidth
        gdev = generator.device if generator is not None else device
        phases = torch.rand((channels,), generator=generator, device=gdev).to(device) - 0.5
        self.weight = nn.Parameter(_randn((channels, channels), generator, device))
        self.register_buffer("transform", torch.eye(3, device=device))
        self.register_buffer("freqs", freqs)
        self.register_buffer("phases", phases)

    def forward(self, w, transform: Optional[torch.Tensor] = None):
        """w (N, w_dim) -> (N, channels, size, size); transform: a (3, 3)
        user transform in place of the buffer's."""
        t = self.affine(w.float())
        t = t / torch.sqrt(t[:, 0:1].square() + t[:, 1:2].square())
        t0, t1, t2, t3 = t[:, 0], t[:, 1], t[:, 2], t[:, 3]
        # the rotation-translation's inverse wrt the image, then the user
        # transform (ref :209-217), its two non-trivial rows
        m00, m01, m02 = t0, -t1, -t0 * t2 + t1 * t3
        m10, m11, m12 = t1, t0, -t1 * t2 - t0 * t3
        u = (self.transform if transform is None else transform).float()
        tr = torch.stack([m00[:, None] * u[0] + m01[:, None] * u[1] + m02[:, None] * u[2],
                          m10[:, None] * u[0] + m11[:, None] * u[1] + m12[:, None] * u[2]],
                         dim=1)   # (N, 2, 3)
        base_f, base_p = self.freqs.float(), self.phases.float()
        fx, fy = base_f[None, :, 0, None], base_f[None, :, 1, None]
        freqs = fx * tr[:, None, 0, :2] + fy * tr[:, None, 1, :2]        # (N, C, 2)
        phases = base_p[None] + (base_f[None, :, 0] * tr[:, None, 0, 2]
                                 + base_f[None, :, 1] * tr[:, None, 1, 2])   # (N, C)
        # dampen the out-of-band frequencies the transform brings in (ref :224)
        fnorm = freqs.square().sum(dim=2).sqrt()
        amplitudes = torch.clamp(1 - (fnorm - self.bandwidth)
                                 / (self.sampling_rate / 2 - self.bandwidth), 0.0, 1.0)
        # affine_grid's pixel centres, align_corners=False (ref :227-230)
        n = self.size
        coord = (((2.0 * torch.arange(n, dtype=torch.float32, device=w.device) + 1.0) / n
                  - 1.0) * (0.5 * n / self.sampling_rate))
        ang = (coord[None, None, :, None] * freqs[:, None, None, :, 0]
               + coord[None, :, None, None] * freqs[:, None, None, :, 1]
               + phases[:, None, None, :])
        x = torch.sin(ang * (2.0 * math.pi)) * amplitudes[:, None, None, :]
        x = torch.einsum("nhwc,oc->nhwo", x, self.weight.float() / math.sqrt(self.channels))
        return x.permute(0, 3, 1, 2)


class SynthesisNetwork3(nn.Module):
    """The layer geometry of ref networks_stylegan3.py:400-487: cutoffs,
    stopbands, sampling rates, sizes and channels from a geometric
    progression; layers named L{idx}_{size}_{channels}."""

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768,
                 channel_max=512, num_layers=14, num_critical=2, first_cutoff=2.0,
                 first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3, margin_size=10,
                 output_scale=0.25, num_fp16_res=4, use_bf16=False, conv_kernel=3,
                 filter_size=6, lrelu_upsampling=2, use_radial_filters=False,
                 conv_clamp: Optional[float] = 256.0, generator=None, device=None):
        super().__init__()
        self.img_resolution, self.num_layers = img_resolution, num_layers
        self.output_scale, self.use_bf16 = output_scale, use_bf16
        self.num_ws = num_layers + 2   # input affine + layers + torgb (ref :420)
        last_cutoff = img_resolution / 2
        last_stopband = last_cutoff * last_stopband_rel
        exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
        cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
        stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
        rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
        half_widths = np.maximum(stopbands, rates / 2) - cutoffs
        sizes = rates + margin_size * 2
        sizes[-2:] = img_resolution
        channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
        channels[-1] = img_channels
        self.bf16_flags = [bool(rates[i] * (2 ** num_fp16_res) > img_resolution)
                           for i in range(num_layers + 1)]
        self.input = SynthesisInput3(w_dim, int(channels[0]), int(sizes[0]), float(rates[0]),
                                     float(cutoffs[0]), generator, device)
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            is_torgb = idx == num_layers
            is_crit = idx >= num_layers - num_critical
            layer = SynthesisLayer3(
                w_dim, int(channels[prev]), int(channels[idx]), int(sizes[prev]),
                int(sizes[idx]), int(rates[prev]), int(rates[idx]), float(cutoffs[prev]),
                float(cutoffs[idx]), float(half_widths[prev]), float(half_widths[idx]),
                conv_kernel=1 if is_torgb else conv_kernel, lrelu_upsampling=lrelu_upsampling,
                filter_size=filter_size,
                # radial filters on the non-critically-sampled layers only (ref :319)
                use_radial_filters=use_radial_filters and not is_crit,
                conv_clamp=conv_clamp, is_torgb=is_torgb, generator=generator, device=device)
            name = f"L{idx}_{int(sizes[idx])}_{int(channels[idx])}"
            setattr(self, name, layer)
            self.layer_names.append(name)

    def forward(self, ws, transform: Optional[torch.Tensor] = None):
        """ws (N, num_ws, w_dim) -> (N, img_channels, res, res) f32."""
        x = self.input(ws[:, 0], transform)
        for i, name in enumerate(self.layer_names):
            x = x.to(torch.bfloat16 if self.use_bf16 and self.bf16_flags[i] else torch.float32)
            x = getattr(self, name)(x, ws[:, i + 1])
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.float()


class Generator3(nn.Module):
    """StyleGAN3 generator (ref networks_stylegan3.py:491-515): the
    StyleGAN2 mapping network with 2 layers (the SG3 mapping, :111-166, is
    the same computation under the same names) and SynthesisNetwork3."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 mapping_num_layers=2, mapping_lr_multiplier=0.01, mapping_w_avg_beta=0.998,
                 synthesis_kwargs: Optional[dict] = None, generator=None, device=None):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.img_resolution, self.img_channels = img_resolution, img_channels
        self.synthesis = SynthesisNetwork3(w_dim, img_resolution, img_channels,
                                           generator=generator, device=device,
                                           **(synthesis_kwargs or {}))
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, self.num_ws,
                                      num_layers=mapping_num_layers,
                                      lr_multiplier=mapping_lr_multiplier,
                                      w_avg_beta=mapping_w_avg_beta, generator=generator,
                                      device=device)

    def forward(self, z, c=None, truncation_psi=1.0, truncation_cutoff=None):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws)
