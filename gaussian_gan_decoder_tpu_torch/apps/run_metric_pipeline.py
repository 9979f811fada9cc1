"""Batch metric runner — port of apps/run_metric_pipeline.py (the
reference's eg3d/run_metric_pipeline.py:17-28, which runs calc_metrics.py
in a subprocess over a config list).

    python -m gaussian_gan_decoder_tpu_torch.apps.run_metric_pipeline \\
        --batch batch.json [--dry_run] [--stop_on_error]

    batch.json: [["--checkpoint", "a.ckpt", "--data", "real.zip", "--metrics", "fid50k_full"],
                 ["--network_pkl", "g.pkl", "--data", "real.zip", "--metrics", "kid50k_full"]]

Each entry is the argv of one `python -m
gaussian_gan_decoder_tpu_torch.apps.calc_metrics` run, in its own
subprocess so that no run's device memory leaks into the next (the
reference's isolation); add "--force_cpu" to an entry to run it on the
CPU. Prints each command, then {"runs": [{args, returncode}]}; exits 1 if
a run failed.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

MODULE = "gaussian_gan_decoder_tpu_torch.apps.calc_metrics"


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", required=True, help="JSON file: list of calc_metrics argv lists")
    p.add_argument("--dry_run", action="store_true", help="print the commands without running them")
    p.add_argument("--stop_on_error", action="store_true")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    with open(args.batch) as f:
        batch = json.load(f)
    if not isinstance(batch, list):
        raise SystemExit("run_metric_pipeline: the batch JSON must be a list of argv lists")
    results = []
    for i, item_args in enumerate(batch):
        cmd = [sys.executable, "-m", MODULE, *map(str, item_args)]
        print(f"[{i + 1}/{len(batch)}] {' '.join(cmd)}", flush=True)
        if args.dry_run:
            results.append({"args": item_args, "returncode": None})
            continue
        r = subprocess.run(cmd)
        results.append({"args": item_args, "returncode": r.returncode})
        if r.returncode != 0 and args.stop_on_error:
            break
    print(json.dumps({"runs": results}))
    return results


if __name__ == "__main__":
    rs = main()
    sys.exit(0 if all(r["returncode"] in (0, None) for r in rs) else 1)
