"""The port's classic 3DGS apps and scene readers on the CPU: the COLMAP and
Blender readers and the stats collector against the JAX package's copies
(equal values), full_eval_3dgs (train, render, metrics) on a tiny Blender
scene, render_3dgs against JAX's on the same .ply (metrics within 1e-4
relative and PNGs within one 8-bit level: the same f32 render up to
rounding), and train_3dgs serving the remote viewer."""
import json
import os
import socket
import threading
import time

import jax
import numpy as np
import pytest
from PIL import Image

from gaussian_gan_decoder_tpu.apps.render_3dgs import main as jrender_main
from gaussian_gan_decoder_tpu.data import scene_io as jscene_io
from gaussian_gan_decoder_tpu.utils.stats import Collector as JCollector
from gaussian_gan_decoder_tpu_torch.apps.full_eval_3dgs import main as full_eval_main
from gaussian_gan_decoder_tpu_torch.apps.render_3dgs import main as render_main
from gaussian_gan_decoder_tpu_torch.apps.train_3dgs import main as train_main
from gaussian_gan_decoder_tpu_torch.data import scene_io
from gaussian_gan_decoder_tpu_torch.utils.stats import Collector
from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_scene_io import _write_colmap


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _make_blender_scene(root, size=32):
    """Two 32^2 views 3 units out, as tests/test_full_eval_3dgs.py makes."""
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    rng = np.random.RandomState(0)
    frames = []
    for i in range(2):
        c2w = np.eye(4)
        c2w[2, 3] = 3.0
        c2w[0, 3] = 0.2 * i
        name = f"train/r_{i}"
        Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(
            os.path.join(root, name + ".png"))
        frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    return root


def _same_scene(a, b):
    assert len(a.cameras) == len(b.cameras)
    for ca, cb in zip(a.cameras, b.cameras):
        for f in ("R", "T", "fovx", "fovy", "image_path", "width", "height"):
            np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f), err_msg=f)
        for x, y in zip(scene_io.camera_to_render_inputs(ca),
                        jscene_io.camera_to_render_inputs(cb)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert a.extent == b.extent


def test_scene_readers_and_stats_match_jax(tmp_path):
    root = _write_colmap(tmp_path / "colmap")
    _same_scene(scene_io.read_colmap_scene(str(root)), jscene_io.read_colmap_scene(str(root)))
    for name in ("cameras", "images"):
        fn = f"read_{name}_binary"
        path = str(root / "sparse" / "0" / f"{name}.bin")
        got, want = getattr(scene_io, fn)(path), getattr(jscene_io, fn)(path)
        assert got.keys() == want.keys()
        for k in got:
            for f in got[k]:
                np.testing.assert_array_equal(got[k][f], want[k][f])
    blender = _make_blender_scene(str(tmp_path / "blender"))
    for white in (False, True):
        _same_scene(scene_io.read_blender_scene(blender, white, n_random_points=300),
                    jscene_io.read_blender_scene(blender, white, n_random_points=300))
    rows = []
    for cls in (Collector, JCollector):
        c = cls(str(tmp_path / f"{cls.__module__}.jsonl"))
        for v in (1.0, 2.0, 4.0):
            c.report({"loss": v, "n": 3 * v})
        assert c.mean("loss") == pytest.approx(7 / 3) and c.std("n") > 0
        row = c.flush(5)
        row.pop("wall")
        rows.append(row)
    assert rows[0] == rows[1]


def test_full_eval_and_render_match_jax(tmp_path):
    scene = _make_blender_scene(str(tmp_path / "toy"))
    out = str(tmp_path / "eval")
    summary = full_eval_main(["--scenes", scene, "--output_path", out, "--iterations", "10",
                              "--capacity", "256", "--image_size", "32", "--force_cpu"])
    assert os.path.exists(os.path.join(out, "full_eval.json"))
    mean = summary["toy"]["mean"]
    assert set(mean) == {"PSNR", "SSIM", "L1", "LPIPS"}
    assert all(np.isfinite(v) for v in mean.values())
    assert all("LPIPS" in r for r in summary["toy"]["per_view"])
    ply = os.path.join(out, "toy", "point_cloud", "final", "point_cloud.ply")
    assert os.path.exists(ply)
    with open(os.path.join(out, "toy", "stats.jsonl")) as f:
        assert json.loads(f.readline())["step"] == 0
    # render_3dgs against JAX's on the port's trained scene
    args = ["--ply", ply, "-s", scene, "--image_size", "32", "--skip_lpips", "--force_cpu"]
    got = render_main(args + ["--out", str(tmp_path / "t")])
    jrender_main(args + ["--out", str(tmp_path / "j")])
    with open(tmp_path / "j" / "metrics.json") as f:
        want = json.load(f)
    for k in ("PSNR", "SSIM", "L1"):
        assert got["mean"][k] == pytest.approx(want["mean"][k], rel=1e-4), k
    for i in range(2):
        a = np.asarray(Image.open(tmp_path / "t" / f"{i:05d}.png"), np.int32)
        b = np.asarray(Image.open(tmp_path / "j" / f"{i:05d}.png"), np.int32)
        assert np.abs(a - b).max() <= 1 and a.std() > 0


def test_train_3dgs_serves_the_viewer(tmp_path):
    """--gui_port: a SIBR-protocol client gets the current render and the
    scene path (ref gaussian_splatting/train.py:52-65)."""
    scene = _make_blender_scene(str(tmp_path / "toy"))
    got = {}

    def client(port):
        for _ in range(400):
            try:
                cli = socket.create_connection(("127.0.0.1", port), timeout=0.2)
                break
            except OSError:
                time.sleep(0.02)
        else:
            return
        msg = {"resolution_x": 32, "resolution_y": 32, "train": True, "fov_x": 0.7,
               "fov_y": 0.7, "z_near": 0.01, "z_far": 10.0, "shs_python": False,
               "rot_scale_python": False, "keep_alive": True, "scaling_modifier": 1.0,
               "view_matrix": list(np.eye(4).reshape(-1)),
               "view_projection_matrix": list(np.eye(4).reshape(-1))}
        blob = json.dumps(msg).encode()
        cli.sendall(len(blob).to_bytes(4, "little") + blob)
        img, want = b"", 32 * 32 * 3
        cli.settimeout(60)
        while len(img) < want:
            chunk = cli.recv(want - len(img))
            if not chunk:
                return
            img += chunk
        n = int.from_bytes(cli.recv(4), "little")
        got["verify"] = cli.recv(n).decode()
        got["img"] = img

    # a client thread may be starved of the GIL for a whole run on a
    # loaded host: the exchange is under test, so up to three runs
    for _ in range(3):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        t = threading.Thread(target=client, args=(port,), daemon=True)
        t.start()
        train_main(["-s", scene, "-m", str(tmp_path / "out"), "--iterations", "60",
                    "--capacity", "256", "--image_size", "32", "--gui_port", str(port),
                    "--save_iterations", "--force_cpu"])
        t.join(timeout=30)
        if got.get("img") is not None:
            break
    assert got.get("img") is not None and len(got["img"]) == 32 * 32 * 3
    assert got["verify"] == scene
