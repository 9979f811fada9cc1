"""3D-GAN adversarial training CLI — port of apps/train_gan.py.

    python -m gaussian_gan_decoder_tpu_torch.apps.train_gan --smoke \\
        --force_cpu --kimg 0.01 --outdir OUT
    python -m gaussian_gan_decoder_tpu_torch.apps.train_gan --data imgs.zip \\
        --seg_data segs.zip [--variant eg3d] [--aug fixed --ada_p 0.2] ...

The JAX app's flags and loop (ref PanoHead/train.py, training_loop.py:90):
the PanoHead (mask_dual D, with --seg_data) or EG3D (dual D) generator
and discriminator on seeded random weights, or resumed (--resume) from a
snapshot directory this app wrote (the whole train state) or a reference
GAN .pkl (G, G_ema and D weights); batches from an image zip or directory
with dataset.json labels (data/dataset.py), the real raw and mask resized
to the neural rendering resolution; one train_gan step a batch
(train/gan.py); stats.jsonl through utils/stats.Collector; snapshots
snapshot_NNNNNN and snapshot_final (train/checkpoint.py: G, D, G_ema, both
Adams, step, cur_nimg, and the configs as JSON); fakes_{init,NNNNNN,final}.png
from G_ema at 4 fixed latents (JAX's: jax.random.normal(PRNGKey(seed + 7)),
utils/jax_random.py). Runs on the card unless --force_cpu, and raises
without one.

--aug ada / fixed augment D's inputs with the ADA pipe at probability
--ada_p. As in the JAX app, the step reads the p it was built with: the
JAX app updates ada_p on the host every 4 steps, but its step is traced
once with the first p as a constant, so the update never reaches it
(ROADMAP, reference-side behaviours). The port keeps that behaviour.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--outdir", default="./gan_runs")
    p.add_argument("--data", default="", help="image zip/dir with dataset.json")
    p.add_argument("--seg_data", default="", help="segmentation zip (PanoHead)")
    p.add_argument("--cfg", default="ffhq", choices=["ffhq", "afhq", "shapenet"])
    p.add_argument("--variant", default="panohead", choices=["panohead", "eg3d"])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--kimg", type=float, default=25000)
    p.add_argument("--glr", type=float, default=0.0025)
    p.add_argument("--dlr", type=float, default=0.002)
    p.add_argument("--gamma", type=float, default=1.0, help="R1 weight")
    p.add_argument("--gen_pose_cond", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--gpc_reg_prob", type=float, default=0.5)
    p.add_argument("--density_reg", type=float, default=0.25)
    p.add_argument("--trans_reg", type=float, default=10.0)
    p.add_argument("--aug", default="noaug", choices=["noaug", "ada", "fixed"])
    p.add_argument("--ada_p", type=float, default=0.0)
    p.add_argument("--snap", type=int, default=50, help="snapshot every N ticks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--img_resolution", type=int, default=512)
    p.add_argument("--neural_rendering_resolution_initial", type=int, default=64)
    p.add_argument("--neural_rendering_resolution_final", type=int, default=None)
    p.add_argument("--neural_rendering_resolution_fade_kimg", type=int, default=1000)
    p.add_argument("--num_fp16_res", type=int, default=4,
                   help="bf16 blocks at the top N resolutions")
    p.add_argument("--resume", default="",
                   help="a snapshot directory of this app (the whole train state) or a "
                        "reference GAN snapshot .pkl (G, G_ema and D weights)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def build_networks(args, device):
    """(G, D, G_ema, neural rendering resolution) of the flags, on seeded
    random weights (G, then D, from torch.Generator().manual_seed(seed))."""
    import torch

    from ..models.discriminator import Discriminator
    from ..models.triplane import TriPlaneGenerator

    rng = torch.Generator().manual_seed(args.seed)
    mode = "mask_dual" if args.variant == "panohead" else "dual"
    if args.smoke:
        gkw = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=32, variant=args.variant,
                   without_sr=True, channel_base=512, channel_max=32,
                   rendering_kwargs={"triplane_size": 16, "depth_resolution": 4,
                                     "depth_resolution_importance": 4})
        dkw = dict(c_dim=25, img_resolution=16, img_channels=3, mode=mode, channel_base=256,
                   channel_max=32, num_fp16_res=0, conv_clamp=None, seg_resolution=8,
                   mbstd_group_size=2)
        nrr = 16
    else:
        gkw = dict(z_dim=512, c_dim=25, w_dim=512, img_resolution=args.img_resolution,
                   variant=args.variant, num_fp16_res=args.num_fp16_res,
                   sr_num_fp16_res=args.num_fp16_res)
        dkw = dict(c_dim=25, img_resolution=args.img_resolution, img_channels=3, mode=mode,
                   num_fp16_res=args.num_fp16_res)
        nrr = args.neural_rendering_resolution_initial
    G = TriPlaneGenerator(**gkw, generator=rng, device=device)
    D = Discriminator(**dkw, generator=rng, device=device)
    G_ema = TriPlaneGenerator.from_config(G.config, device=device)
    return G, D, G_ema, nrr


def loss_config(args, nrr):
    from ..train.gan import GANLossConfig
    return GANLossConfig(
        r1_gamma=args.gamma,
        trans_reg=args.trans_reg if args.variant == "panohead" else 0.0,
        density_reg=args.density_reg,
        gpc_reg_prob=args.gpc_reg_prob if args.gen_pose_cond else None,
        g_lr=args.glr, d_lr=args.dlr, batch_size=args.batch,
        neural_rendering_resolution_initial=nrr,
        neural_rendering_resolution_final=(
            None if args.smoke else args.neural_rendering_resolution_final),
        neural_rendering_resolution_fade_kimg=args.neural_rendering_resolution_fade_kimg)


def augment_for(args):
    """The step's augment_fn for --aug / --ada_p (None under noaug): the
    ADA pipe on D's image at the fixed p --ada_p."""
    if args.aug == "noaug":
        return None
    from ..train.augment import AugmentConfig, augment_pipe
    acfg, p = AugmentConfig(), float(args.ada_p)

    def augment_fn(draws, img):
        out = dict(img)
        out["image"] = augment_pipe(draws, img["image"], p, acfg)
        return out

    return augment_fn


def real_images(img, seg, nrr: int, device):
    """A numpy batch -> the step's real dict: the image, and the raw and the
    mask resized to the neural rendering resolution (an all-ones mask
    without a segmentation)."""
    import torch

    from ..models.discriminator import filtered_resizing
    if seg is None:
        seg = np.ones((img.shape[0], 1) + img.shape[2:], np.float32)
    img_t = torch.from_numpy(img).to(device)
    return {"image": img_t, "image_raw": filtered_resizing(img_t, nrr),
            "image_mask": filtered_resizing(torch.from_numpy(seg).to(device), nrr)}


def resume(path: str, state):
    """Fill `state` from a --resume source, strictly."""
    if path.endswith(".pkl"):
        from ..port.from_jax import load_discriminator_state, load_generator_state
        from ..port.torch_pickle import load_gan_snapshot_pkl

        snap = load_gan_snapshot_pkl(path)
        load_generator_state(state.G, snap["g_params"])
        load_generator_state(state.G_ema, snap["g_ema"])
        if snap["d_params"] is not None:
            load_discriminator_state(state.D, snap["d_params"])
        print(f"resumed G/D/G_ema weights from reference pickle {path}")
        return state
    from ..train import checkpoint

    state = checkpoint.restore(path, state)
    print(f"resumed train state from {path} (step {state.step})")
    return state


def real_batches(args, resolution: int, batch: int):
    """Numpy batches (images [-1, 1], segmentation [0, 1] or None, labels)
    at `resolution`, from --data / --seg_data, or the JAX app's synthetic
    stream (--smoke without --data)."""
    if args.data:
        from ..data import ImageFolderDataset, InfiniteSampler, MaskLabeledDataset, batch_iterator

        if args.seg_data:
            ds = MaskLabeledDataset(args.data, args.seg_data, resolution=resolution, xflip=True)
        else:
            ds = ImageFolderDataset(args.data, resolution=resolution, xflip=True)
        for b in batch_iterator(ds, batch, InfiniteSampler(len(ds), seed=args.seed)):
            yield (b[0], b[1], b[2]) if len(b) == 3 else (b[0], None, b[1])
    if not args.smoke:
        raise SystemExit("train_gan: --data is required unless --smoke")
    rng, r = np.random.RandomState(0), resolution
    while True:
        img = rng.rand(batch, 3, r, r) * 2 - 1
        seg = rng.rand(batch, 1, r, r)
        lab = rng.randn(batch, 25) * 0.1
        yield img.astype(np.float32), seg.astype(np.float32), lab.astype(np.float32)


def main(argv=None):
    """-> {"state": the final GANTrainState, "outdir", "snapshots": [paths],
    "fakes": [paths], "steps"}."""
    args = build_argparser().parse_args(argv)
    import torch

    from ..flagship import resolve_device
    from ..train import checkpoint
    from ..train.augment import ada_update
    from ..train.gan import init_gan_state, make_gan_train_step
    from ..utils.draws import TorchDraws
    from ..utils.jax_random import seed_normal
    from ..utils.stats import Collector

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    os.makedirs(args.outdir, exist_ok=True)
    G, D, G_ema, nrr = build_networks(args, dev)
    cfg = loss_config(args, nrr)

    ada_p = np.float32(args.ada_p)
    state = init_gan_state(G, D, G_ema, cfg)
    if args.resume:
        state = resume(args.resume, state)
    step_fn = make_gan_train_step(G, D, cfg, augment_fn=augment_for(args))
    configs = {"G": G.config, "D": D.config, "loss_cfg": cfg}
    # the real images at the resolution D takes (the JAX app reads --data at
    # G's, which under --smoke is 32² against the smoke D's 16²)
    batches = real_batches(args, D.img_resolution, args.batch)
    stats = Collector(os.path.join(args.outdir, "stats.jsonl"))
    rng = torch.Generator(device=dev).manual_seed(args.seed + 1)
    draws = TorchDraws(rng, dev)
    total_steps = max(int(args.kimg * 1000 / args.batch), 1)
    nrr_img = cfg.neural_rendering_resolution_initial
    out = {"outdir": args.outdir, "snapshots": [], "fakes": [], "steps": total_steps}

    # fixed-grid fakes from G_ema (ref training_loop.py:363-400)
    grid_n = 4
    grid_z = torch.from_numpy(seed_normal(args.seed + 7, (grid_n, G.z_dim))).to(dev)
    cam = np.eye(4, dtype=np.float32).reshape(-1).tolist() + [4.2647, 0, 0.5, 0, 4.2647, 0.5,
                                                              0, 0, 1]
    grid_c = torch.tensor([cam] * grid_n, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def save_fakes(tag):
        from PIL import Image

        ims = []
        for j in range(grid_n):
            z, c = grid_z[j:j + 1], grid_c[j:j + 1]
            o = state.G_ema.synthesis(state.G_ema.mapping(z, c), c,
                                      neural_rendering_resolution=nrr_img)
            ims.append((o["image"] if "image" in o else o["image_raw"])[0].float().cpu().numpy())
        grid = np.concatenate(ims, axis=2)
        arr = np.clip((grid.transpose(1, 2, 0) + 1) * 127.5, 0, 255).astype(np.uint8)
        path = os.path.join(args.outdir, f"fakes_{tag}.png")
        Image.fromarray(arr).save(path)
        out["fakes"].append(path)

    def snapshot(tag):
        path = os.path.join(args.outdir, f"snapshot_{tag}")
        checkpoint.save(path, state, configs=configs)
        out["snapshots"].append(path)

    save_fakes("init")
    for i in range(total_steps):
        img, seg, lab = next(batches)
        real = real_images(img, seg, nrr_img, dev)
        z = torch.randn((img.shape[0], G.z_dim), generator=rng, device=dev)
        c = torch.from_numpy(lab).to(dev)
        state, metrics = step_fn(state, draws, z, c, real, c)
        stats.report({k: float(v) for k, v in metrics.items()})
        if args.aug == "ada" and i % 4 == 0:
            ada_p = ada_update(ada_p, np.sign(stats.mean("Loss/scores/real")), args.batch)
        if i % 50 == 0:
            row = stats.flush(i)
            print(f"[{i}/{total_steps}] " + " ".join(
                f"{k.split('/')[-1]}={v:.3f}" for k, v in row.items() if k.startswith("Loss/")))
        if args.snap > 0 and i > 0 and i % (args.snap * 100) == 0:
            snapshot(f"{i:06d}")
            save_fakes(f"{i:06d}")
    snapshot("final")
    save_fakes("final")
    print("done; final snapshot written")
    out["state"] = state
    out["ada_p"] = float(ada_p)
    return out


if __name__ == "__main__":
    main()
