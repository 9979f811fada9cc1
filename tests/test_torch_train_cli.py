"""The port's distillation CLI (apps/train_decoder.py): a --smoke run on the
CPU takes its steps and logs them (every step with --scalars_interval 1),
the default device is the card, and the flags of paths the port does not
run raise NotImplementedError."""
import json
import math
import os

import pytest
import torch

from gaussian_gan_decoder_tpu_torch.apps import train_decoder
from _torch_threads import torch_threads  # noqa: F401  (autouse)


def test_smoke_run_logs_every_step(tmp_path):
    out = train_decoder.main(["--random_init", "--smoke", "--force_cpu", "--num_iter", "3",
                              "--scalars_interval", "1", "--eval_steps", "1",
                              "--outdir", str(tmp_path)])
    with open(os.path.join(out["outdir"], "stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert "final_eval" in rows.pop()
    assert [r["step"] for r in rows] == [0, 1, 2]
    for r in rows:
        assert math.isfinite(r["Loss/total"]) and r["Loss/total"] > 0
        assert r["General/n_dropped"] == 0
    assert rows[0]["General/n_pairs"] > 0
    with open(os.path.join(out["outdir"], "training_options.json")) as f:
        assert json.load(f)["num_iter"] == 3


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_decoder.main(["--random_init", "--smoke", "--num_iter", "1",
                            "--outdir", str(tmp_path)])


@pytest.mark.parametrize("flags", [
    ["--bf16_lpips"], ["--batch_views", "2"], ["--pallas_probe_build"],
    ["--int8_probe"], ["--bf16_probe"], ["--raster_backend", "xla"],
    ["--no-use_marching_cubes"], ["--no-mt_two_stage"]])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_decoder.build(train_decoder.build_argparser().parse_args(
            ["--random_init", "--smoke", "--force_cpu"] + flags))
