#!/usr/bin/env python3
"""A multi-hundred-step distillation run of the port on one NVIDIA GPU, and
its resume from a saved train state.

    python3 scripts/loss_curve.py [--keep DIR] [--steps 300]
                                  [--resume_at 200] [--cpu_smoke]

The runs write into a temporary directory (a flagship snapshot is ~260 MB),
removed at the end; --keep (default gaussian_gan_decoder_tpu_torch/_build/
loss_curve, ignored by git) receives every run's stats.jsonl (also when a
run fails) and the render.

1. The marching-tetrahedra level: the 0.9 quantile of the first latent's
   128^3 sigma grid of the seeded random flagship generator (the CLI's
   level 10 crosses no cube of a random field; chip_smoke.py's choice).
2. A seeded random IR-SE50 (losses/id_loss.py::random_irse50), written as
   a .pt, so the runs carry the ID term on frontal draws; then the
   untrained decoder's eval on the final eval's samples, and FIT_STEPS
   (100) steps of a fresh trainer on one fixed draw (does it fit one
   target?).
3. apps/train_decoder --random_init --num_iter STEPS --save_model_interval
   SAVE_INTERVAL (100) --eval_steps 10 --scalars_interval 1 --id_weights
   that .pt: every step's losses and wall time in stats.jsonl, snapshots
   at 100 and 200, the final eval and decoder_final.
4. The same command to RESUME_AT steps, then checkpoint.save of its train
   state, then the first command again with --load_checkpoint on it.
5. apps/render_decoder on the first run's decoder_final with --ply, and
   apps/eval_decoder on it for 2 steps.

Prints one JSON summary: the eval before and after training, the one-draw
fit's loss by 10 steps, the mean loss of steps 0-49 and of the last 50,
the median step wall time with and without the ID term, the final eval,
the snapshot, .pt, .npz and .ply sizes, the resumed run's first logged
step, and the card's name and power limit. --cpu_smoke runs the same
steps on the CPU with the --smoke generator (no ID term, level 0.5), to
check the script; its times are CPU times.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keep", default=str(REPO / "gaussian_gan_decoder_tpu_torch" / "_build" /
                                          "loss_curve"))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--resume_at", type=int, default=200)
    ap.add_argument("--seed", type=int, default=303)
    ap.add_argument("--save_interval", type=int, default=100)
    ap.add_argument("--fit_steps", type=int, default=100)
    ap.add_argument("--cpu_smoke", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not (torch.cuda.is_available() or args.cpu_smoke):
        print("loss_curve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    keep = Path(args.keep)
    keep.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            summary = _runs(args, Path(tmp), torch)
        finally:   # every run's stats.jsonl, also when a run fails
            for f in Path(tmp).glob("*/run*/stats.jsonl"):
                shutil.copy(f, keep / f"{f.parent.parent.name}_stats.jsonl")
    print(json.dumps(summary))
    return 0


def _runs(args, out: Path, torch):
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.apps import eval_decoder, render_decoder, train_decoder
    from gaussian_gan_decoder_tpu_torch.decoder.surface import (
        marching_tetrahedra_faces, sigma_grid_separable)
    from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetDraws
    from gaussian_gan_decoder_tpu_torch.losses import random_irse50
    from gaussian_gan_decoder_tpu_torch.train import checkpoint
    from gaussian_gan_decoder_tpu_torch.train.eval import run_eval

    if args.cpu_smoke:
        smi, level, n_faces, cpu = "CPU (--cpu_smoke)", 0.5, None, ["--smoke", "--force_cpu"]
    else:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, check=True).stdout.strip()
        cpu = []
        # 1. the surface level of the first latent the trainer draws
        dev = torch.device("cuda:0")
        gen = flagship.flagship_generator(rng=torch.Generator().manual_seed(args.seed),
                                          device=dev)
        z0 = torch.randn((1, gen.z_dim), generator=torch.Generator().manual_seed(args.seed + 1))
        with torch.no_grad():
            ws = gen.mapping(z0.to(dev), torch.zeros((1, gen.c_dim), device=dev))
            sig = sigma_grid_separable(gen, gen.synthesis_planes(ws), shape_res=128)
            level = float(torch.quantile(sig.flatten(), 0.9))
            _, n_faces, _ = marching_tetrahedra_faces(sig, level, 2 ** 20)
        del gen, ws, sig
        torch.cuda.empty_cache()
    # 2. a seeded random IR-SE50
    irse_path = str(out / "irse50_random.pt")
    torch.save(random_irse50(torch.Generator().manual_seed(5)).state_dict(), irse_path)

    common = cpu + ["--random_init", "--seed", str(args.seed), "--mc_level", repr(level),
                    "--id_weights", irse_path, "--scalars_interval", "1",
                    "--logging_interval", str(args.save_interval)]
    # the untrained decoder on the final eval's samples (the trainer's seed +
    # 99, 10 steps), then FIT_STEPS steps on one fixed draw
    fresh = train_decoder.build(train_decoder.build_argparser().parse_args(common))
    eval0 = run_eval(torch.Generator().manual_seed(args.seed + 99), fresh.decoder, fresh.gen,
                     fresh.vgg, fresh.irse, eval_steps=10, cfg=fresh.cfg,
                     target_cfg=fresh.tcfg, raster_cfg=fresh.rcfg)
    g = torch.Generator().manual_seed(args.seed + 7)
    z = torch.randn((1, fresh.gen.z_dim), generator=g).to(fresh.dev)
    draws = TargetDraws.make(g, fresh.gen, fresh.tcfg, fresh.dev)
    fit, fit_pairs = [], None
    for i in range(args.fit_steps):
        metrics = fresh.step(fresh.state, [draws], z[None], i)[1]
        fit.append(float(metrics["Loss/total"]))
        fit_pairs = fit_pairs or int(metrics["General/n_pairs"])
    del fresh, draws
    # 3. the run
    t0 = time.perf_counter()
    run = train_decoder.main(common + ["--num_iter", str(args.steps), "--save_model_interval",
                                       str(args.save_interval), "--eval_steps", "10",
                                       "--outdir", str(out / "run")])
    run_s = time.perf_counter() - t0
    # 4. the resume
    part = train_decoder.main(common + ["--num_iter", str(args.resume_at), "--save_model_interval",
                                        str(10 ** 9), "--eval_steps", "0",
                                        "--outdir", str(out / "part")])
    state_path = str(out / f"train_state_{args.resume_at}")
    checkpoint.save(state_path, part["state"], {"decoder": part["state"].decoder.config})
    del part
    resumed = train_decoder.main(common + ["--num_iter", str(args.steps), "--save_model_interval",
                                           str(10 ** 9), "--eval_steps", "10",
                                           "--load_checkpoint", state_path,
                                           "--outdir", str(out / "resumed")])
    # 5. the render and eval apps on the run's decoder_final
    final = os.path.join(run["outdir"], "decoder_final")
    render = render_decoder.main(cpu[1:] + ["--checkpoint", final, "--out",
                                            str(out / "render.png"), "--ply",
                                            str(out / "render.ply")])
    evals = eval_decoder.main(cpu[1:] + ["--checkpoint", final, "--eval_steps", "2"])

    def rows(outdir):
        with open(os.path.join(outdir, "stats.jsonl")) as f:
            return [json.loads(line) for line in f]

    steps = [r for r in rows(run["outdir"]) if "step" in r]
    loss = [r["Loss/total"] for r in steps]
    # a row's wall is the time since the previous row (one step at interval 1)
    walls = [(r["wall"], r["Loss/id"] != 0.0) for r in steps[1:]]
    with_id = [w for w, i in walls if i]
    without = [w for w, i in walls if not i]
    res_steps = [r for r in rows(resumed["outdir"]) if "step" in r]
    size = lambda p: os.path.getsize(p)  # noqa: E731
    summary = {
        "card": smi, "mc_level": level, "faces": n_faces, "steps": len(steps),
        "loss_mean_first_50": statistics.fmean(loss[:50]),
        "loss_mean_last_50": statistics.fmean(loss[-50:]),
        "loss_first": loss[0], "loss_last": loss[-1],
        "loss_mean_by_50": [statistics.fmean(loss[i:i + 50]) for i in range(0, len(loss), 50)],
        "pairs_mean_by_50": [statistics.fmean(r["General/n_pairs"] for r in steps[i:i + 50])
                             for i in range(0, len(steps), 50)],
        "step_wall_ms_median_with_id": 1e3 * statistics.median(with_id) if with_id else None,
        "step_wall_ms_median_without_id": 1e3 * statistics.median(without),
        "steps_with_id": len(with_id), "run_seconds": run_s,
        "eval_at_step_0": eval0, "final_eval": run["final_eval"],
        "fit_one_draw_pairs": fit_pairs, "fit_one_draw_first": fit[0], "fit_one_draw_mean_last_10": statistics.fmean(fit[-10:]),
        "fit_one_draw_by_10": [statistics.fmean(fit[i:i + 10]) for i in range(0, len(fit), 10)],
        "snapshot_bytes": size(os.path.join(run["outdir"], f"decoder_{args.save_interval:06d}")),
        "pt_bytes": size(os.path.join(run["outdir"], f"decoder{args.save_interval}.pt")),
        "npz_bytes": size(os.path.join(run["outdir"], f"decoder{args.save_interval}.npz")),
        "train_state_bytes": size(state_path),
        "ply_bytes": size(render["ply"]),
        "resumed_first_logged_step": res_steps[0]["step"],
        "resumed_loss_mean_last_50": statistics.fmean([r["Loss/total"] for r in res_steps[-50:]]),
        "resumed_final_eval": resumed["final_eval"], "eval_app": evals,
    }
    shutil.copy(render["image"], Path(args.keep) / os.path.basename(render["image"]))
    return summary


if __name__ == "__main__":
    sys.exit(main())
