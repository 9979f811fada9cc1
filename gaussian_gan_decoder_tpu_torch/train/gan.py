"""3D-GAN adversarial training (PanoHead / EG3D) — port of train/gan.py.

The JAX package's functional step, run eagerly. One step is the G phase
(mapping with the generator-pose-conditioning swap, PanoHead's
self-adaptive camera, synthesis at the neural rendering resolution, D on
the fakes; + the camera-translation and density TV regularisers on lazy
steps; Adam on G), then the D phase on the updated G (fakes without
gradient, reals; + the lazy R1 penalty on image, raw and segmentation
through a double backward; Adam on D), then the EMA of G (ref loss.py:
23-319, training_loop.py:90-495).

Where the JAX package traces one program with lax.cond / lax.switch, the
port branches in Python: lazy regularisation on step % interval, the
neural-rendering-resolution fade by the level nearest the rounded fade
(the JAX levels, multiples of 8); the raw, depth and mask renders resize
to the fade's largest level, as there.

What the step trains is JAX's g_params: every tensor of G's state dict,
the synthesis' noise_const and the mapping's w_avg buffers included (JAX
carries them as leaves of the param tree, and optax moves the noise
constants once a noise strength is non-zero). Each phase takes gradients
of its own network alone (torch.autograd.grad): the G phase writes none
into D, the D phase none into G, and the D phase's fakes are detached.

Every random draw is a named site of a draws object (utils/draws.py):
'g' / 'd' for the phases, then 'G' (run_G: 'swap', 'render'), 'D' /
'fake' / 'real' / 'r1' (run_D: 'aug', 'noise') and 'reg' ('pts',
'perturb', 'swap'), the sites where the JAX step splits its key.

reg_type is a field of GANLossConfig that neither package reads: every
value runs the L1 TV term, as the JAX step does (train/gan.py:238).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.discriminator import Discriminator, filtered_resizing
from ..models.triplane import TriPlaneGenerator
from ..neuralfield.renderer import RenderDraws


@dataclass(frozen=True)
class GANLossConfig:
    r1_gamma: float = 10.0
    r1_gamma_seg: float = 1000.0
    trans_reg: float = 10.0
    density_reg: float = 0.25
    density_reg_p_dist: float = 0.004
    reg_type: str = "l1"                 # 'l1' | 'monotonic-detach' | 'monotonic-fix'
    blur_init_sigma: float = 0.0
    blur_fade_kimg: float = 0.0
    gpc_reg_prob: Optional[float] = 0.5
    gpc_reg_fade_kimg: float = 1000.0
    style_mixing_prob: float = 0.0
    neural_rendering_resolution_initial: int = 64
    neural_rendering_resolution_final: Optional[int] = None
    neural_rendering_resolution_fade_kimg: float = 0.0
    dual_discrimination: bool = True
    filter_mode: str = "antialiased"
    g_reg_interval: int = 4
    d_reg_interval: int = 16
    g_lr: float = 0.0025
    d_lr: float = 0.002
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = 0.05
    batch_size: int = 4


@dataclass
class GANTrainState:
    G: TriPlaneGenerator
    D: Discriminator
    G_ema: TriPlaneGenerator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0
    cur_nimg: float = 0.0


def trained_tensors(module: torch.nn.Module) -> List[torch.Tensor]:
    """The tensors of module's state dict (parameters and persistent
    buffers), in its order: the leaves of the JAX package's param tree."""
    own = dict(module.named_parameters())
    own.update(dict(module.named_buffers()))
    return [own[k] for k in module.state_dict()]


def make_adam(tensors, lr: float, reg_interval: int) -> torch.optim.Adam:
    """Adam with the lazy-regularisation ratio r = interval / (interval + 1):
    lr · r, betas (0 ** r, 0.99 ** r), eps 1e-8 (ref train.py's
    mb_ratio)."""
    ratio = reg_interval / (reg_interval + 1)
    for t in tensors:
        t.requires_grad_(True)
    return torch.optim.Adam(tensors, lr=lr * ratio, betas=(0.0 ** ratio, 0.99 ** ratio),
                            eps=1e-8)


def init_gan_state(G: TriPlaneGenerator, D: Discriminator, G_ema: TriPlaneGenerator,
                   cfg: GANLossConfig = GANLossConfig()) -> GANTrainState:
    """The train state over G and D as they are; G_ema takes G's tensors."""
    G_ema.load_state_dict(G.state_dict(), strict=True)
    G_ema.requires_grad_(False)
    return GANTrainState(G, D, G_ema,
                         make_adam(trained_tensors(G), cfg.g_lr, cfg.g_reg_interval),
                         make_adam(trained_tensors(D), cfg.d_lr, cfg.d_reg_interval), 0, 0.0)


def swap_conditioning(draws, c, swapping_prob):
    """The generator-pose-conditioning swap (ref loss.py:57-62): each row
    takes the previous row's camera with probability swapping_prob."""
    take = draws.uniform((c.shape[0], 1)).to(c.device) < swapping_prob
    return torch.where(take, torch.roll(c, 1, dims=0), c)


def blur_image(img, blur_sigma, max_blur_size: int = 12):
    """Gaussian blur with a fading sigma (ref loss.py:82-87): static taps,
    zero weight where |r| > 3 sigma."""
    if max_blur_size <= 0:
        return img
    r = torch.arange(-max_blur_size, max_blur_size + 1, dtype=torch.float32, device=img.device)
    sigma = max(float(blur_sigma), 1e-8)
    f = torch.exp2(-(r / sigma).square())
    f = torch.where(r.abs() <= math.floor(float(blur_sigma) * 3), f, 0.0)
    f = f / f.sum()
    c = img.shape[1]
    w = f.reshape(1, 1, -1, 1).expand(c, 1, -1, 1).to(img.dtype)
    img = F.conv2d(img, w, padding=(max_blur_size, 0), groups=c)
    return F.conv2d(img, w.transpose(2, 3), padding=(0, max_blur_size), groups=c)


class GANStep:
    """make_gan_train_step's step (`__call__`) and its two losses, which
    the tests hold against the JAX package's."""

    def __init__(self, G: TriPlaneGenerator, D: Discriminator, cfg: GANLossConfig,
                 augment_fn: Optional[Callable] = None):
        self.G, self.D, self.cfg, self.augment_fn = G, D, cfg, augment_fn
        lo_hi = (cfg.neural_rendering_resolution_initial, cfg.neural_rendering_resolution_final)
        nrr_init, nrr_final = lo_hi
        self.fading = (nrr_final is not None and nrr_final != nrr_init
                       and cfg.neural_rendering_resolution_fade_kimg > 0)
        if self.fading:
            lo, hi = sorted(lo_hi)
            levels = tuple(range(lo, hi, 8)) + (hi,)
            self.nrr_levels = tuple(reversed(levels)) if nrr_init > nrr_final else levels
        else:
            self.nrr_levels = (nrr_init,)

    # -- schedules (f32, as the JAX step computes them) --------------------------

    def nrr(self, cur_nimg) -> int:
        cfg = self.cfg
        if not self.fading:
            return self.nrr_levels[0]
        f32 = np.float32
        alpha = min(f32(cur_nimg) / f32(cfg.neural_rendering_resolution_fade_kimg * 1e3), f32(1))
        nrr_t = np.round(f32(cfg.neural_rendering_resolution_initial)
                         + f32(cfg.neural_rendering_resolution_final
                               - cfg.neural_rendering_resolution_initial) * f32(alpha))
        levels = np.asarray(self.nrr_levels, np.float32)
        return self.nrr_levels[int(np.argmin(np.abs(levels - nrr_t)))]

    def schedules(self, cur_nimg):
        cfg, f32 = self.cfg, np.float32
        blur_sigma = (max(f32(1) - f32(cur_nimg) / f32(cfg.blur_fade_kimg * 1e3), f32(0))
                      * f32(cfg.blur_init_sigma) if cfg.blur_fade_kimg > 0 else f32(0))
        if cfg.gpc_reg_prob is not None:
            alpha = (min(f32(cur_nimg) / f32(cfg.gpc_reg_fade_kimg * 1e3), f32(1))
                     if cfg.gpc_reg_fade_kimg > 0 else f32(1))
            swapping_prob = (f32(1) - alpha) * f32(1) + alpha * f32(cfg.gpc_reg_prob)
        else:
            swapping_prob = f32(0)
        return float(blur_sigma), float(swapping_prob)

    # -- the networks' runs --------------------------------------------------------

    def run_G(self, draws, z, c, swapping_prob, nrr):
        G, cfg = self.G, self.cfg
        c_cond = swap_conditioning(draws.child("swap"), c, swapping_prob)
        ws = G.mapping(z, c_cond)
        if G.variant == "panohead":
            c_new, delta_c = G.apply_delta_c(z, c)
        else:
            c_new, delta_c = c, torch.zeros((c.shape[0], 3), device=c.device)
        n, rk, rd = c.shape[0], G.rk, draws.child("render")
        render = RenderDraws(rd.uniform((n, nrr * nrr, rk["depth_resolution"], 1)).to(c.device),
                             rd.uniform((n * nrr * nrr, rk["depth_resolution_importance"]))
                             .to(c.device))
        out = dict(G.synthesis(ws, c_new, render, neural_rendering_resolution=nrr))
        out.pop("feature_planes", None)
        out_res = max(self.nrr_levels)
        if nrr != out_res:
            for k in ("image_raw", "image_depth", "image_mask"):
                if k in out:
                    out[k] = filtered_resizing(out[k], out_res, cfg.filter_mode)
        if "image" not in out:   # without_sr: the raw render is the image
            out["image"] = out["image_raw"]
        return out, ws, delta_c

    def run_D(self, draws, img, c, blur_sigma):
        if self.cfg.blur_fade_kimg > 0:
            img = dict(img)
            img["image"] = blur_image(img["image"], blur_sigma)
        if self.augment_fn is not None:
            img = self.augment_fn(draws.child("aug"), img)
        noise = (draws.child("noise").normal(tuple(c.shape)).to(c.device)
                 if self.D.disc_c_noise > 0 else None)
        return self.D(img, c, noise=noise)

    # -- the losses ----------------------------------------------------------------

    def g_loss(self, draws, z, c, cur_nimg, do_reg: bool):
        """-> (G loss, metrics), on the draws' 'g' sites."""
        G, cfg = self.G, self.cfg
        blur_sigma, swapping_prob = self.schedules(cur_nimg)
        nrr = self.nrr(cur_nimg)
        gen_img, _, delta_c = self.run_G(draws.child("G"), z, c, swapping_prob, nrr)
        gen_logits = self.run_D(draws.child("D"), gen_img, c, blur_sigma)
        loss_g = F.softplus(-gen_logits).mean()
        metrics = {"Loss/G/loss": loss_g.detach(), "Loss/scores/fake": gen_logits.detach().mean(),
                   "Progress/nrr": torch.tensor(float(nrr))}
        if G.variant == "panohead" and cfg.trans_reg > 0:
            loss_trans = delta_c.mean(dim=0).square().sum() * cfg.trans_reg
            loss_g = loss_g + loss_trans
            metrics["Loss/G/trans_reg_loss"] = loss_trans.detach()
        if cfg.density_reg > 0:
            if do_reg:
                loss_reg = self.density_reg(draws.child("reg"), z, c, swapping_prob)
            else:
                loss_reg = torch.zeros((), device=z.device)
            loss_g = loss_g + loss_reg * cfg.g_reg_interval
            metrics["Loss/G/reg"] = loss_reg.detach()
        return loss_g, metrics

    def density_reg(self, draws, z, c, swapping_prob):
        """The density TV term (ref loss.py:148-180): sigma at 1000 points
        in the box against sigma at their perturbations, L1."""
        G, cfg, n_pts = self.G, self.cfg, 1000
        pts = ((draws.child("pts").uniform((z.shape[0], n_pts, 3)).to(z.device) * 2 - 1)
               * (G.rk["box_warp"] / 2))
        perturbed = (pts + draws.child("perturb").normal(tuple(pts.shape)).to(z.device)
                     * cfg.density_reg_p_dist)
        coords = torch.cat([pts, perturbed], dim=1)
        ws = G.mapping(z, swap_conditioning(draws.child("swap"), c, swapping_prob))
        sigma = G.sample_mixed(coords, torch.zeros_like(coords), ws)["sigma"]
        return (sigma[:, n_pts:] - sigma[:, :n_pts]).abs().mean() * cfg.density_reg

    def d_loss(self, draws, z, c, real_img: Dict[str, torch.Tensor], real_c, cur_nimg,
               do_reg: bool):
        """-> (D loss, metrics), on the draws' 'd' sites; the fakes come from
        G as it is now, without gradient."""
        D, cfg = self.D, self.cfg
        blur_sigma, swapping_prob = self.schedules(cur_nimg)
        nrr = self.nrr(cur_nimg)
        with torch.no_grad():
            gen_img, _, _ = self.run_G(draws.child("G"), z, c, swapping_prob, nrr)
        real_img = dict(real_img)
        if self.fading and "image_raw" in real_img:
            # the real raw at the current level, resized back to the largest
            real_img["image_raw"] = filtered_resizing(
                filtered_resizing(real_img["image"], nrr, cfg.filter_mode),
                max(self.nrr_levels), cfg.filter_mode)
        gen_logits = self.run_D(draws.child("fake"), gen_img, c, blur_sigma)
        loss_fake = F.softplus(gen_logits).mean()
        real_logits = self.run_D(draws.child("real"), real_img, real_c, blur_sigma)
        loss_real = F.softplus(-real_logits).mean()
        metrics = {"Loss/D/loss": (loss_fake + loss_real).detach(),
                   "Loss/scores/real": real_logits.detach().mean()}
        loss = loss_fake + loss_real
        if cfg.r1_gamma > 0:
            loss_r1 = (self.r1(draws.child("r1"), real_img, real_c, blur_sigma) if do_reg
                       else torch.zeros((), device=real_c.device))
            metrics["Loss/r1_penalty"] = loss_r1.detach()
            loss = loss + loss_r1 * cfg.d_reg_interval
        return loss, metrics

    def r1(self, draws, real_img, real_c, blur_sigma):
        """Lazy R1 on the image, the raw (dual discrimination) and the mask
        ('mask_dual'), through a double backward (ref loss.py:276-303)."""
        cfg = self.cfg
        names = ["image",
                 "image_raw" if cfg.dual_discrimination else None,
                 "image_mask" if self.D.mode == "mask_dual" else None]
        names = [k for k in names if k is not None and real_img.get(k) is not None]
        img = dict(real_img)
        for k in names:
            img[k] = real_img[k].detach().requires_grad_(True)
        d_sum = self.run_D(draws, img, real_c, blur_sigma).sum()
        grads = list(torch.autograd.grad(d_sum, [img[k] for k in names], create_graph=True))
        # image (+ raw) share r1_gamma; the mask takes r1_gamma_seg, in the
        # JAX step's order of the gradients it has
        pen = grads.pop(0).square().sum(dim=(1, 2, 3)).mean() * (cfg.r1_gamma / 2)
        if cfg.dual_discrimination and grads:
            pen = pen + grads.pop(0).square().sum(dim=(1, 2, 3)).mean() * (cfg.r1_gamma / 2)
        if self.D.mode == "mask_dual" and grads:
            pen = pen + grads.pop(0).square().sum(dim=(1, 2, 3)).mean() * (cfg.r1_gamma_seg / 2)
        return pen

    # -- the step -----------------------------------------------------------------

    @staticmethod
    def _apply(opt: torch.optim.Adam, tensors, loss):
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        for t, g in zip(tensors, grads):
            t.grad = torch.zeros_like(t) if g is None else g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def __call__(self, state: GANTrainState, draws, z, c, real_img, real_c,
                 stage_timer: Optional[Callable[[str], None]] = None):
        """One G phase, one D phase and the EMA -> (state, metrics: 0-d
        tensors on the card). stage_timer, when given, is called with 'G',
        'D' and 'ema' as each phase is issued."""
        cfg = self.cfg
        mark = stage_timer or (lambda name: None)
        do_g_reg = state.step % cfg.g_reg_interval == 0
        do_d_reg = state.step % cfg.d_reg_interval == 0
        g_tensors, d_tensors = trained_tensors(state.G), trained_tensors(state.D)

        # D's tensors stay out of the G phase's graph; the D phase runs G
        # without gradient
        for t in d_tensors:
            t.requires_grad_(False)
        mark("G")
        g_loss, g_metrics = self.g_loss(draws.child("g"), z, c, state.cur_nimg, do_g_reg)
        self._apply(state.g_opt, g_tensors, g_loss)
        for t in d_tensors:
            t.requires_grad_(True)
        mark("D")
        d_loss, d_metrics = self.d_loss(draws.child("d"), z, c, real_img, real_c,
                                        state.cur_nimg, do_d_reg)
        self._apply(state.d_opt, d_tensors, d_loss)

        mark("ema")
        state.cur_nimg = float(np.float32(state.cur_nimg) + np.float32(cfg.batch_size))
        ema_update(state.G_ema, state.G, ema_beta(cfg, state.cur_nimg))
        state.step += 1
        return state, {**g_metrics, **d_metrics}


def ema_beta(cfg: GANLossConfig, cur_nimg: float) -> float:
    """0.5 ** (batch / ema_nimg), ema_nimg ramped up with cur_nimg (ref
    training_loop.py:303-315), in f32 as the JAX step computes it."""
    f32 = np.float32
    ema_nimg = f32(cfg.ema_kimg * 1000.0)
    if cfg.ema_rampup is not None:
        ema_nimg = min(ema_nimg, f32(cur_nimg) * f32(cfg.ema_rampup))
    return float(f32(0.5) ** (f32(cfg.batch_size) / max(f32(ema_nimg), f32(1e-8))))


@torch.no_grad()
def ema_update(G_ema: torch.nn.Module, G: torch.nn.Module, beta: float) -> None:
    """G_ema <- G + (G_ema - G) · beta over every tensor of the state dict."""
    src = G.state_dict()
    for k, e in G_ema.state_dict().items():
        p = src[k]
        e.copy_(p + (e - p) * beta)


def make_gan_train_step(G: TriPlaneGenerator, D: Discriminator,
                        cfg: GANLossConfig = GANLossConfig(),
                        augment_fn: Optional[Callable] = None) -> GANStep:
    """-> step(state, draws, z, c, real_img, real_c) -> (state, metrics).
    augment_fn(draws, img_dict) -> img_dict is the ADA pipe."""
    return GANStep(G, D, cfg, augment_fn)
