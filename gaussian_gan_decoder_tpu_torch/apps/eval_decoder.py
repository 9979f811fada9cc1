"""Decoder evaluation CLI — port of apps/eval_decoder.py (ref main/eval.py
run_eval, see train/eval.py).

    python -m gaussian_gan_decoder_tpu_torch.apps.eval_decoder \\
        --checkpoint results/runX/decoder_final [--eval_steps 100] [--force_cpu]

Prints the Metrics10k/* means as JSON. The VGG16 is seeded random without
--vgg_weights; --id_weights (IR-SE50 weights, .pth / .pt) adds the
near-frontal ID similarity.
"""
from __future__ import annotations

import argparse
import json


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--eval_steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vgg_weights", default="")
    p.add_argument("--id_weights", default="")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch

    from ..decoder.snapshot import load_decoder
    from ..flagship import resolve_device
    from ..losses import IRSE50, VGG16LPIPS, load_irse50_state
    from ..port.from_jax import load_vgg16_lpips_state
    from ..train.distill import DistillConfig
    from ..train.eval import run_eval

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    decoder, configs = load_decoder(args.checkpoint, device=dev)
    vgg = VGG16LPIPS(generator=torch.Generator().manual_seed(7), device=dev)
    if args.vgg_weights:
        load_vgg16_lpips_state(vgg, args.vgg_weights)
    irse = None
    if args.id_weights:
        irse = IRSE50(device=dev)
        load_irse50_state(irse, args.id_weights)
    metrics = run_eval(torch.Generator().manual_seed(args.seed), decoder,
                       configs.get("frozen_G", decoder.G), vgg, irse,
                       eval_steps=args.eval_steps, cfg=configs.get("distill_cfg", DistillConfig()),
                       target_cfg=configs["target_cfg"])
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
