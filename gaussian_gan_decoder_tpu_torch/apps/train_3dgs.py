"""Classic photogrammetric 3DGS training CLI — port of apps/train_3dgs.py.

    python -m gaussian_gan_decoder_tpu_torch.apps.train_3dgs -s SCENE \\
        [-m OUT] [--iterations N] [--capacity C] [--force_cpu]

A COLMAP (sparse/0) or Blender (transforms_train.json) scene in; the
reference's schedule (train.py:31-226): a numpy RandomState(0) camera a
step, one SH degree up every 1,000 steps, densification every 100 steps
from step 500 to 15,000 with an opacity reset every 3,000, the remote
viewer polled every 5 steps with --gui_port; .ply files out. As in JAX,
the scene's active_sh_degree stays 0 (the step takes the degree as an
argument), so the .ply files carry the degree-0 layout. Runs on the card
unless --force_cpu.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", default="./gs_output")
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--capacity", type=int, default=2 ** 20)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--image_size", type=int, default=512,
                   help="training render size (GT resized)")
    p.add_argument("--save_iterations", type=int, nargs="*", default=[7_000, 30_000])
    p.add_argument("--gui_port", type=int, default=0,
                   help=">0: serve the SIBR remote viewer while training "
                        "(ref gaussian_splatting/train.py:52-65)")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def load_image(path: str, size: int, device):
    """An RGB image resized to size^2 (Lanczos) -> (3, size, size) f32 in [0, 1]."""
    import torch
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size), Image.LANCZOS)
    return torch.tensor(np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0, device=device)


def read_scene(source_path: str, white_background: bool, n_random_points: int = 100_000):
    """A COLMAP scene where source_path holds sparse/, else a Blender one
    (with n_random_points random initial points)."""
    from ..data.scene_io import read_blender_scene, read_colmap_scene

    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_scene(source_path)
    return read_blender_scene(source_path, white_background, n_random_points=n_random_points)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch

    from ..data.scene_io import camera_to_render_inputs
    from ..flagship import resolve_device
    from ..gaussians.cameras import make_camera
    from ..gaussians.densify import reset_opacity
    from ..gaussians.ply import save_ply
    from ..splat.rasterize import RasterizeConfig, rasterize
    from ..train.gaussian_splatting import (GSOptimizationConfig, assign_scene, densify_step,
                                            init_gs_state, make_train_step)
    from ..utils.stats import Collector

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    info = read_scene(args.source_path, args.white_background,
                      n_random_points=min(100_000, args.capacity // 2))
    print(f"{len(info.cameras)} cameras, {len(info.points)} init points, "
          f"extent {info.extent:.2f}")

    cfg = GSOptimizationConfig(iterations=args.iterations, capacity=args.capacity,
                               sh_degree=args.sh_degree)
    rcfg = RasterizeConfig()
    state = init_gs_state(info.points, info.colors, cfg, spatial_lr_scale=info.extent,
                          device=dev)
    step = make_train_step(cfg, rcfg, args.image_size, info.extent)
    bg = torch.full((3,), 1.0 if args.white_background else 0.0, device=dev)
    os.makedirs(args.model_path, exist_ok=True)
    stats = Collector(os.path.join(args.model_path, "stats.jsonl"))

    gui = None
    if args.gui_port > 0:
        from ..gaussians.network_gui import NetworkGUI

        gui = NetworkGUI("127.0.0.1", args.gui_port, device=dev)
        print(f"network GUI on 127.0.0.1:{args.gui_port}")

    def gui_poll(scene, sh_deg):
        """The viewer's camera rendered from the current Gaussians at the
        step's SH degree; socket errors are swallowed (ref train.py:52-65).
        (JAX reads the scene's degree-0 features at every degree, its
        indexing clamped past them; here the features of that degree.)"""
        if gui.conn is None:
            gui.try_connect()
            return
        try:
            gui.conn.settimeout(0.005)
            try:
                cam, _t, _k, smod, (w, h), _m = gui.receive()
            finally:
                gui.conn.settimeout(None)
            if cam is None:
                gui.send(None, args.source_path)
                return
            shs = scene._replace(active_sh_degree=sh_deg).get_features
            with torch.no_grad():
                out = rasterize(cam, scene.get_xyz, scene.get_scaling, scene.get_rotation,
                                scene.get_opacity, shs=shs, sh_degree=sh_deg, bg=bg,
                                config=rcfg, scale_modifier=smod)
            img = (torch.clamp(out["render"] * 255, 0, 255).cpu().numpy()).astype(np.uint8)
            gui.send(img.transpose(1, 2, 0).tobytes(), args.source_path)
        except (BlockingIOError, TimeoutError):
            pass
        except (ConnectionError, BrokenPipeError, OSError, ValueError):
            # ValueError: the JSON of a half-read or closed socket
            gui.conn = None

    rng = np.random.RandomState(0)
    key = torch.Generator(device=dev).manual_seed(0)
    gt_cache = {}
    for i in range(args.iterations):
        sh_deg = min(i // 1000, cfg.sh_degree)  # oneupSHdegree schedule
        if gui is not None and i % 5 == 0:
            gui_poll(state.scene, sh_deg)
        ci = int(rng.randint(len(info.cameras)))
        sc = info.cameras[ci]
        if ci not in gt_cache:
            gt_cache[ci] = load_image(sc.image_path, args.image_size, dev)
        cam2world, fov = camera_to_render_inputs(sc)
        cam = make_camera(args.image_size, fov, cam2world, device=dev)
        state, metrics = step(state, cam, gt_cache[ci], bg, sh_degree=sh_deg)
        stats.report({k: float(metrics[k]) for k in ("loss", "l1", "n_valid")})

        if cfg.densify_from_iter <= i < cfg.densify_until_iter:
            if i % cfg.densification_interval == 0 and i > 0:
                mss = 20.0 if i > cfg.opacity_reset_interval else None
                state, _ = densify_step(state, key, cfg, info.extent, mss)
            if i % cfg.opacity_reset_interval == 0 and i > 0:
                state = assign_scene(state, reset_opacity(state.scene))

        if i % 100 == 0:
            row = stats.flush(i)
            print(f"[{i}] loss={row.get('loss', 0):.4f} n={int(metrics['n_valid'])}")
        if i in args.save_iterations:
            save_ply(state.scene, os.path.join(
                args.model_path, f"point_cloud/iteration_{i}/point_cloud.ply"))

    final = os.path.join(args.model_path, "point_cloud/final/point_cloud.ply")
    save_ply(state.scene, final)
    print("done")
    return {"state": state, "ply": final}


if __name__ == "__main__":
    main()
