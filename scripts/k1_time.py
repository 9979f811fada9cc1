#!/usr/bin/env python3
"""K1's own time on one NVIDIA GPU: CUDA events around N wrapper calls
queued behind a ~10 ms device sleep (the device runs them back to back:
chip_smoke.py's measure), the device time of mapping_kernel from
torch.profiler (the mean over the launches it saw: it has been seen to miss
some), and CUDA events around N calls on an idle device (which at tens of
microseconds read the host's launch path).

    python3 scripts/k1_time.py [--root DIR] [--iters N]

Imports gaussian_gan_decoder_tpu_torch from DIR (default: this checkout),
so that one run can time another checkout's K1 (a parent commit unpacked
beside this one) on the same card. The mapping is the flagship's (z 512,
c 25, w 512, 8 layers, seeded weights), at batch 1 (the frames) and 4 (the
stream's frame batch), c the zeroed camera as the frames give it (K1's time
does not depend on c). Prints one line per batch and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("k1_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
    from gaussian_gan_decoder_tpu_torch.models.stylegan2 import MappingNetwork

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    mn = MappingNetwork(512, 25, 512, num_ws=14, generator=g)
    fm = pallas_mapping.fold_mapping(mn.to(dev))
    for B in (1, 4):
        z = torch.randn(B, 512, generator=g).to(dev)
        c = torch.zeros((B, 25), device=dev)
        call = lambda: pallas_mapping.mapping_forward(z, c, fm)  # noqa: E731
        call()
        torch.cuda.synchronize()
        t = []
        for queued in (True, False):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(args.iters):
                call()
            end.record()
            torch.cuda.synchronize()
            t.append(start.elapsed_time(end) / args.iters)
        queued_ms, ev_ms = t
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                call()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "mapping_kernel" in e.key]
        n = sum(e.count for e in ev)
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / max(n, 1)
        print(f"K1 ({args.root}) B {B}: {queued_ms:.4f} ms device (queued events), "
              f"{dev_ms:.4f} ms device (profiler, {n} of {args.iters} launches seen), "
              f"{ev_ms:.4f} ms a call (events around {args.iters} calls)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
