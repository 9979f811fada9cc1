"""GAN / decoder metric CLI — port of apps/calc_metrics.py (the reference's
eg3d/calc_metrics.py, :99-100 --use_decoder, with run_metric_pipeline.py's
batching).

    python -m gaussian_gan_decoder_tpu_torch.apps.calc_metrics --data real.zip \\
        (--network_pkl network.pkl | --checkpoint decoder_snapshot) \\
        [--metrics fid50k_full,kid50k_full,pr50k3_full,is50k,ppl2_wend] \\
        [--num_items 50000] [--batch 8] [--inception pt_inception.pth] \\
        [--vgg_weights vgg16.npz] [--force_cpu]

Computes each metric over the real images (a zip or directory with
dataset.json labels; their labels are the stream's cameras) against a
ported GAN's images (metrics/metric_main.generator_image_batches) or a
decoder snapshot's (decoder-FID: decoder_image_batches, the frozen
target's surface decoded and splatted with the 'xla' rasterizer at
512^2). The features are the InceptionV3's with --inception (a
pytorch-fid state dict: published-comparable, and is50k), else the
VGG16-LPIPS embedder's pooled taps (seeded random without --vgg_weights:
values compare only between runs of this package with the same seed).
Prints one JSON line a metric, then all results. Runs on the card unless
--force_cpu, and raises without one.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--metrics", default="fid50k_full", help="comma list")
    p.add_argument("--data", required=True, help="real image zip/dir with labels")
    p.add_argument("--network_pkl", default="", help="reference GAN .pkl")
    p.add_argument("--checkpoint", default="", help="decoder snapshot (decoder-FID)")
    p.add_argument("--num_items", type=int, default=50_000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--vgg_weights", default="", help="fallback embedder weights")
    p.add_argument("--inception", default="",
                   help="InceptionV3 state dict (.pth, pytorch-fid names): fid/kid/pr "
                        "comparable to published numbers, and is50k")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def feature_functions(inception: str, vgg_weights: str, device):
    """-> (feature_fn, logits_fn or None): images [0, 255] (numpy or torch,
    NCHW) -> features on `device`."""
    import torch

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device)

    if inception:
        from ..metrics.inception import load_inception
        net = load_inception(inception, device=device)
        return (torch.no_grad()(lambda x: net.features(tensor(x))),
                torch.no_grad()(lambda x: net.logits(tensor(x))))
    from ..losses.image import area_downsample
    from .invert import make_vgg
    vgg = make_vgg(vgg_weights, device)
    if not vgg_weights:
        print("WARNING: random-weight embedder — metric values are only comparable across "
              "runs of this package with the same seed")

    @torch.no_grad()
    def feat(x):
        x = tensor(x)
        if x.shape[-1] > 256 and x.shape[-1] % 256 == 0:
            x = area_downsample(x, 256)
        return vgg.pooled_features(x)
    return feat, None


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    import torch

    from ..data import ImageFolderDataset, InfiniteSampler
    from ..flagship import resolve_device
    from ..metrics.metric_main import calc_metric, decoder_image_batches, generator_image_batches
    from ..utils import jax_random

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    ds = ImageFolderDataset(args.data, use_labels=True)
    sampler = iter(InfiniteSampler(len(ds), seed=0))

    def real_batches():
        while True:
            yield np.stack([ds[next(sampler)][0] for _ in range(args.batch)]).astype(np.float32)

    def c_source():
        while True:
            yield np.stack([ds.get_label(next(sampler))
                            for _ in range(args.batch)]).astype(np.float32)

    feat, logits_fn = feature_functions(args.inception, args.vgg_weights, dev)
    if args.checkpoint:
        from ..decoder.snapshot import load_decoder
        decoder, configs = load_decoder(args.checkpoint, device=dev)
        decoder.eval()

        gen_batches = decoder_image_batches(decoder, configs.get("frozen_G", decoder.G),
                                            configs.get("target_cfg"), jax_random.PRNGKey(1),
                                            c_source())
    else:
        if not args.network_pkl:
            raise SystemExit("calc_metrics: --network_pkl or --checkpoint is required")
        from ..port.torch_pickle import load_generator_pkl
        gen, _ = load_generator_pkl(args.network_pkl, device=dev)
        gen.eval()

        gen_batches = generator_image_batches(gen, jax_random.PRNGKey(1), args.batch,
                                              c_source())

    out = {}
    for m in args.metrics.split(","):
        kwargs = {"device": dev}
        if m == "ppl2_wend":
            # PPL needs the GAN's mapping and synthesis (ref perceptual_path_length.py
            # renders both endpoints in one call under the same c)
            if args.checkpoint:
                raise SystemExit("calc_metrics: ppl2_wend runs on a GAN, not a decoder")

            @torch.no_grad()
            def synthesis_fn(ws, c):
                return gen.synthesis(ws, c)["image"]

            @torch.no_grad()
            def dist_fn(a, b):
                # the [-1, 1] synthesis mapped to [0, 255] as the feature input
                fa = feat(torch.clamp((a + 1) * 127.5, 0, 255))
                fb = feat(torch.clamp((b + 1) * 127.5, 0, 255))
                return (fa - fb).square().sum(dim=-1)

            kwargs.update(mapping_fn=torch.no_grad()(lambda key, z, c: gen.mapping(z, c)),
                          synthesis_fn=synthesis_fn, dist_fn=dist_fn, c_source=c_source(),
                          num_samples=args.num_items, batch_size=args.batch, z_dim=gen.z_dim,
                          c_dim=gen.c_dim)
        # one generated stream for every metric, as the JAX app: each goes on
        # where the last one stopped
        r = calc_metric(m, real_batches=real_batches(), gen_batches=gen_batches,
                        feature_fn=feat, logits_fn=logits_fn, num_items=args.num_items, **kwargs)
        out.update(r["results"])
        print(json.dumps(r))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
