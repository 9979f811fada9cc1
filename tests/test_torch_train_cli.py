"""The port's distillation CLI (apps/train_decoder.py): a --smoke run on the
CPU takes its steps and logs them (every step with --scalars_interval 1),
the default device is the card, each of the JAX trainer's option flags
builds into the configs, and a step with every option on at once runs."""
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


# each flag -> (config, field, value) that the built trainer must carry
FLAGS = {
    "--bf16_lpips": ("cfg", "lpips_bf16", True),
    "--batch_views 2": (None, "views", 2),
    "--pallas_probe_build": ("tcfg", "pallas_probe_build", True),
    "--int8_probe": ("tcfg", "int8_probe", True),
    "--bf16_probe": ("tcfg", "bf16_probe", True),
    "--raster_backend xla": ("cfg", "raster_backend", "xla"),
    "--no-use_marching_cubes": ("tcfg", "use_marching_cubes", False),
    "--no-mt_two_stage": ("tcfg", "mt_two_stage", False),
    "--no-sigma_separable": ("tcfg", "sigma_separable", False),
}


def _build(flags):
    return train_decoder.build(train_decoder.build_argparser().parse_args(
        ["--random_init", "--smoke", "--force_cpu"] + flags))


@pytest.mark.parametrize("flag", list(FLAGS))
def test_ported_flags_build(flag):
    """Each of the JAX trainer's option flags builds on the CPU, and the
    built configs (or the run's views a step) carry it."""
    where, field, value = FLAGS[flag]
    run, default = _build(flag.split()), _build([])
    assert getattr(getattr(run, where) if where else run, field) == value
    assert getattr(getattr(default, where) if where else default, field) != value


def test_every_option_takes_a_step(tmp_path):
    """One --smoke step with every option on at once: two views, the probe
    options (int8 overriding bf16), the gather sigma grid, the voxel filter
    (single-stage marching tetrahedra asked for too, and unused), bf16
    LPIPS and the 'xla' rasterizer; --int8_probe on an EG3D tri-plane stops
    before the first step."""
    out = train_decoder.main(
        ["--random_init", "--smoke", "--force_cpu", "--num_iter", "1", "--eval_steps", "1",
         "--scalars_interval", "1", "--outdir", str(tmp_path), "--batch_views", "2",
         "--int8_probe", "--bf16_probe", "--pallas_probe_build", "--no-sigma_separable",
         "--no-use_marching_cubes", "--no-mt_two_stage", "--bf16_lpips",
         "--raster_backend", "xla"])
    with open(os.path.join(out["outdir"], "stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert "final_eval" in rows.pop() and [r["step"] for r in rows] == [0]
    assert math.isfinite(rows[0]["Loss/total"]) and rows[0]["Loss/total"] > 0
    assert rows[0]["General/n_pairs"] > 0
    with pytest.raises(SystemExit, match="tri-grid"):
        _build(["--generator_arch", "eg3d_ffhq", "--int8_probe"])
