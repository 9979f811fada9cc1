"""The port's training slice end to end on the CPU: a --smoke run of
apps/train_decoder.py writes every file the JAX loop writes, a train state
saved by train/checkpoint.py resumes at its step, apps/eval_decoder.py and
apps/render_decoder.py run on its decoder_final, and --no-reuse_frozen_planes
makes the frozen copy synthesise its own planes. Copies are compared bit
for bit; the resumed step's loss within 1e-6 (relative) of the same step
taken from the saved state."""
import copy
import json
import math
import os

import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu_torch.apps import eval_decoder, render_decoder, train_decoder
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetDraws
from gaussian_gan_decoder_tpu_torch.gaussians.ply import load_ply_arrays
from gaussian_gan_decoder_tpu_torch.train import checkpoint
from _torch_threads import torch_threads  # noqa: F401  (autouse)

SMOKE = ["--random_init", "--smoke", "--force_cpu"]
# what the JAX loop writes for --num_iter 3 --save_model_interval 2
# --logging_interval 1 (gaussian_gan_decoder_tpu/apps/train_decoder.py:
# 336-369), with the port's torch.save file in place of each orbax directory
JAX_FILES = {"training_options.json", "stats.jsonl", "images/render_000000.png",
             "images/render_000001.png", "images/render_000002.png", "decoder_000002",
             "decoder_000002.config.json", "decoder2.npz", "decoder2.pt", "decoder_final",
             "decoder_final.config.json"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    return train_decoder.main(SMOKE + ["--num_iter", "3", "--save_model_interval", "2",
                                       "--eval_steps", "1", "--logging_interval", "1",
                                       "--outdir", str(out)])


def test_smoke_run_writes_the_jax_loops_files(run):
    outdir = run["outdir"]
    files = {os.path.relpath(os.path.join(d, f), outdir)
             for d, _, fs in os.walk(outdir) for f in fs if "/tb" not in d + "/"}
    assert JAX_FILES <= files, JAX_FILES - files
    with open(os.path.join(outdir, "stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r.get("step") for r in rows[:-1]] == [0] and "wall" in rows[0]
    assert {"Loss/L1", "Loss/LPIPS", "Loss/id", "Loss/total"} <= set(rows[0])
    final = rows[-1]["final_eval"]
    assert set(final) == {f"Metrics10k/{k}" for k in ("L1", "L2", "LPIPS", "DSSIM", "Sobel")}
    assert all(math.isfinite(v) for v in final.values()) and final == run["final_eval"]
    pt = torch.load(os.path.join(outdir, "decoder2.pt"), weights_only=True)
    npz = checkpoint.load_npz(os.path.join(outdir, "decoder2.npz"))
    assert len(pt) == len(npz) > 100 and all(v.dtype == torch.float32 for v in pt.values())
    assert all(np.array_equal(npz[checkpoint.tree_name(k)], v.numpy()) for k, v in pt.items())
    assert "color/fc0/weight" in npz and "G/decoder/fc1/bias" in npz
    # step 2 is the last of the three: its files and decoder_final hold the
    # weights the run ends with
    snap = checkpoint.restore(os.path.join(outdir, "decoder_000002"))
    final = checkpoint.restore(os.path.join(outdir, "decoder_final"))
    end = run["state"].decoder.state_dict()
    assert all(torch.equal(snap["decoder"][k], v) and torch.equal(final["decoder"][k], v)
               and torch.equal(end[k], v) for k, v in pt.items())


def test_saved_state_resumes_at_its_step(run, tmp_path):
    """A train state saved at step 3 resumes there (--load_checkpoint,
    --num_iter 5: steps 3 and 4 logged); one step from the restored state
    gives the loss of the same step from the saved state."""
    path = str(tmp_path / "state")
    saved = run["state"]
    checkpoint.save(path, saved, {"decoder": saved.decoder.config})
    args = train_decoder.build_argparser().parse_args(SMOKE)
    a = train_decoder.build(args)
    a.state = checkpoint.restore(path, a.state)
    assert a.state.step == 3
    for (n, x), y in zip(saved.decoder.state_dict().items(), a.decoder.state_dict().values()):
        assert torch.equal(x, y), n
    b = train_decoder.build(args)
    b.decoder.load_state_dict(copy.deepcopy(saved.decoder.state_dict()))
    b.state.optimizer.load_state_dict(copy.deepcopy(saved.optimizer.state_dict()))
    gen = torch.Generator().manual_seed(9)
    z = torch.randn((1, a.gen.z_dim), generator=gen)
    draws = TargetDraws.make(gen, a.gen, a.tcfg, "cpu")
    la = float(a.step(a.state, [draws], z[None], 3)[1]["Loss/total"])
    lb = float(b.step(b.state, [draws], z[None], 3)[1]["Loss/total"])
    assert abs(la - lb) <= 1e-6 * abs(lb)

    out = train_decoder.main(SMOKE + ["--num_iter", "5", "--load_checkpoint", path,
                                      "--scalars_interval", "1", "--eval_steps", "0",
                                      "--outdir", str(tmp_path / "resumed")])
    with open(os.path.join(out["outdir"], "stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r.get("step") for r in rows[:-1]] == [3, 4] and out["state"].step == 5


def test_eval_and_render_apps_on_decoder_final(run, tmp_path):
    snap = os.path.join(run["outdir"], "decoder_final")
    metrics = eval_decoder.main(["--checkpoint", snap, "--eval_steps", "1", "--force_cpu"])
    assert len(metrics) == 5 and all(math.isfinite(v) for v in metrics.values())
    out = render_decoder.main(["--checkpoint", snap, "--image_size", "32", "--yaw", "0.3",
                               "--out", str(tmp_path / "r.png"), "--ply", str(tmp_path / "r.ply"),
                               "--force_cpu"])
    assert os.path.getsize(out["image"]) > 0
    cols = load_ply_arrays(out["ply"])
    assert len(cols["x"]) == 1024 and np.isfinite(cols["opacity"]).all()
    # --backend xla (the f32 tile rasterizer) renders the same frame as K3
    xla = render_decoder.main(["--checkpoint", snap, "--image_size", "32", "--yaw", "0.3",
                               "--backend", "xla", "--out", str(tmp_path / "x.png"),
                               "--force_cpu"])
    assert float((xla["render"] - out["render"]).abs().max()) <= 1e-4


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no_reuse"])
def test_frozen_copy_planes(reuse):
    """--no-use_gen_finetune: by default the step decodes the frozen
    target's planes; --no-reuse_frozen_planes synthesises the copy's own;
    the copy gets no gradient either way."""
    flags = SMOKE + ["--no-use_gen_finetune"] + ([] if reuse else ["--no-reuse_frozen_planes"])
    r = train_decoder.build(train_decoder.build_argparser().parse_args(flags))
    calls = []
    real = GaussianDecoder.synthesize_planes_train

    def counted(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    gen = torch.Generator().manual_seed(4)
    z = torch.randn((1, r.gen.z_dim), generator=gen)
    draws = TargetDraws.make(gen, r.gen, r.tcfg, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GaussianDecoder, "synthesize_planes_train", counted)
        _, m, _ = r.step(r.state, [draws], z[None], 0)
    assert len(calls) == (0 if reuse else 1) and math.isfinite(float(m["Loss/total"]))
    assert not any(p.requires_grad for p in r.decoder.G.parameters())
