"""Training observability — port of utils/loggers.py: stats.jsonl (always),
render|target compare images in <outdir>/images (PNG through PIL, else
.npy), TensorBoard and wandb when they import.

(ref main/train_pano2gaussian_decoder.py:154-157 writer set-up, :267-296
scalar and compare-image logging; the reference writes TensorBoard
through tensorboardX, which the port prefers)
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


def _np(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


class TrainLogger:
    """Fan-out logger: jsonl (always), TensorBoard and wandb (if importable),
    and compare-image grids."""

    def __init__(self, outdir: str, use_wandb: bool = False,
                 wandb_project: str = "gaussian_gan_decoder_tpu",
                 run_name: Optional[str] = None):
        self.outdir = outdir
        os.makedirs(os.path.join(outdir, "images"), exist_ok=True)
        self._jsonl = open(os.path.join(outdir, "stats.jsonl"), "a")
        self._t_last = time.time()
        self._tb = None
        try:
            self._tb = _summary_writer()(log_dir=os.path.join(outdir, "tb"))
        except Exception:
            pass
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, name=run_name, dir=outdir, config={})
                self._wandb = wandb
            except Exception:
                print("wandb requested but unavailable — skipping")

    def log_scalars(self, step: int, metrics: Dict[str, float]):
        row = {k: float(v) for k, v in metrics.items()}
        row["step"] = int(step)
        now = time.time()
        row["wall"] = now - self._t_last
        self._t_last = now
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k != "step":
                    self._tb.add_scalar(k, v, global_step=step)
        if self._wandb is not None:
            self._wandb.log(row, step=int(step))
        return row

    def log_compare_image(self, step: int, image, target, tag: str = "Render"):
        """Side-by-side render|target grid (the reference's compare_image,
        train_pano2gaussian_decoder.py:268-275). image / target: (3, H, W)
        or (N, 3, H, W) in [0, 1]. -> the path written."""
        img, tgt = _np(image), _np(target)
        if img.ndim == 4:
            img, tgt = img[0], tgt[0]
        grid = np.concatenate([img, tgt], axis=2)
        arr = np.clip(grid.transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
        path = os.path.join(self.outdir, "images", f"{tag.lower()}_{step:06d}.png")
        path = write_image(arr, path)
        if self._tb is not None:
            self._tb.add_image(tag, np.clip(grid, 0, 1), global_step=step)
        if self._wandb is not None:
            self._wandb.log({"compare_output": [self._wandb.Image(arr, caption="Comparison")]},
                            step=int(step))
        return path

    def write_raw(self, obj):
        self._jsonl.write(json.dumps(obj) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def _summary_writer():
    """tensorboardX's SummaryWriter (the reference's writer), else torch's
    (whose import loads TensorFlow where it is installed)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter


def write_image(arr: np.ndarray, path: str) -> str:
    """(H, W, 3) uint8 -> a PNG at `path` through PIL, or, without PIL, the
    array at `path`.npy (as the JAX package does). -> the path written."""
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", arr)
        return path + ".npy"
    Image.fromarray(arr).save(path)
    return path
