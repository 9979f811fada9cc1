"""The port's metric apps on the CPU: calc_metrics --checkpoint --force_cpu
(decoder-FID: FID and KID of a small decoder snapshot's frames against a
tiny synthetic zip, finite), run_metric_pipeline --dry_run naming the
port's calc_metrics module, calc_mbs --smoke --force_cpu against the JAX
app's value on the same weights (both 0: the reference generator forces the background, so the
swap is a no-op in both packages), and --mask_source deeplab raising
without torchvision (never falling back to the gan mask)."""
import copy
import functools
import importlib.util
import json
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.apps import calc_mbs as jcalc_mbs
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port import torch_pickle as jpickle
from gaussian_gan_decoder_tpu_torch.apps import calc_mbs, calc_metrics, invert, run_metric_pipeline
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.snapshot import save_decoder
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetSamplerConfig
from gaussian_gan_decoder_tpu_torch.metrics import metric_main
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from test_torch_train_gan_cli import _write_dataset
from _jax_fast import jax_fast  # noqa: F401  (autouse)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

RK = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4,
      "c_gen_conditioning_zero": True}


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def test_calc_metrics_checkpoint_on_cpu(tmp_path, capsys, monkeypatch):
    """calc_metrics --checkpoint: decoder-FID's FID and KID over 4 frames of
    a 1024-point surface against the zip's images, the VGG16 embedder on
    seeded random weights: finite, KID's JSON line printed. The frames are
    rendered at 32^2 (decoder_image_batches' image_size, set here): at the
    app's 512^2 the CPU rasterizer takes ~15 s a frame; the card runs the
    app at 512^2."""
    _write_dataset(str(tmp_path), n=4, size=32)
    gen = TriPlaneGenerator(rendering_kwargs=RK, without_sr=True, z_dim=32, w_dim=32,
                            img_resolution=32, channel_base=512, channel_max=32,
                            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        gen.decoder.net[2].bias[0] = 0.3   # a surface inside the box
    dec = GaussianDecoder(gen, gelu="exact", rng=torch.Generator().manual_seed(1))
    tcfg = TargetSamplerConfig(shape_res=16, num_points=1024, mc_level=0.5,
                               face_capacity=12 * 15 ** 3, neural_rendering_resolution=32)
    save_decoder(str(tmp_path / "snap"), dec, copy.deepcopy(gen), target_cfg=tcfg)
    monkeypatch.setattr(metric_main, "decoder_image_batches",
                        functools.partial(metric_main.decoder_image_batches, image_size=32))
    out = calc_metrics.main(["--checkpoint", str(tmp_path / "snap"), "--data",
                             str(tmp_path / "imgs.zip"), "--metrics", "fid50k_full,kid50k_full",
                             "--num_items", "4", "--batch", "2", "--force_cpu"])
    assert set(out) == {"fid50k_full", "kid50k_full"}
    assert all(np.isfinite(v) for v in out.values()) and out["fid50k_full"] > 0
    assert '"metric": "kid50k_full"' in capsys.readouterr().out


def test_run_metric_pipeline_dry_run(tmp_path, capsys):
    batch = tmp_path / "batch.json"
    batch.write_text(json.dumps([["--checkpoint", "a", "--data", "d.zip"],
                                 ["--network_pkl", "g.pkl", "--data", "d.zip", "--force_cpu"]]))
    runs = run_metric_pipeline.main(["--batch", str(batch), "--dry_run"])
    assert [r["returncode"] for r in runs] == [None, None]
    lines = capsys.readouterr().out.splitlines()
    assert sum("-m gaussian_gan_decoder_tpu_torch.apps.calc_metrics --" in ln
               for ln in lines) == 2
    assert lines[0].startswith("[1/2] " + sys.executable)


def test_calc_mbs_smoke_matches_jax():
    """calc_mbs --smoke --force_cpu over 4 latents: the JAX app's value, the
    JAX app on the port's smoke weights (its own init, eager, compiles ~130
    programs in ~20 s)."""
    argv = ["--smoke", "--force_cpu", "--n_sample", "4", "--batch", "2"]
    weights = jpickle._nest({k: v.numpy() for k, v in
                             invert.smoke_generator(0, "cpu").state_dict().items()})
    with mock.patch.object(JGen, "init", lambda self, key: weights):
        ref = jcalc_mbs.main(argv)
    got = calc_mbs.main(argv)
    print(f"MBS port {got}, JAX {ref}")
    assert got == ref == 0.0


@pytest.mark.skipif(importlib.util.find_spec("torchvision") is not None,
                    reason="holds the missing-torchvision error; torchvision is installed")
def test_calc_mbs_deeplab_needs_torchvision(tmp_path):
    with pytest.raises(ImportError, match="torchvision"):
        calc_mbs.main(["--smoke", "--force_cpu", "--mask_source", "deeplab",
                       "--deeplab_weights", str(tmp_path / "deeplab.pth")])
