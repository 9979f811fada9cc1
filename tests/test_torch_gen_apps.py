"""The port's five generation apps on the CPU at smoke size, against the JAX
package's apps: the shape files byte for byte JAX's writers' on the same
arrays, gen_videos_proj's camera trajectory within 1e-6 of the JAX app's on
the same latents and pickle (and its --finetuned generator checkpoint),
gen_shapes on a snapshot the port's trainer writes, gen_videos on both
backends, and gen_samples (--random_views, --shapes) and gen_interpolation
(--smoke) writing the files the JAX apps write. The apps draw z from
torch generators, so images are checked for shape and finiteness, not
against JAX's (whose threefry draws give other heads)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.apps import gen_interpolation as jgen_interpolation
from gaussian_gan_decoder_tpu.apps import gen_samples as jgen_samples
from gaussian_gan_decoder_tpu.apps import gen_videos_proj as jgen_videos_proj
from gaussian_gan_decoder_tpu.gaussians import shape_export as jshape_export
from gaussian_gan_decoder_tpu_torch.apps import (gen_interpolation, gen_samples, gen_shapes,
                                                 gen_videos, gen_videos_proj, train_decoder)
from gaussian_gan_decoder_tpu_torch.decoder import heads
from gaussian_gan_decoder_tpu_torch.decoder.snapshot import load_decoder, plain_kernels
from gaussian_gan_decoder_tpu_torch.decoder.surface import marching_tetrahedra_faces
from gaussian_gan_decoder_tpu_torch.gaussians import shape_export
from gaussian_gan_decoder_tpu_torch.splat import fast_raster
from gaussian_gan_decoder_tpu_torch.train import checkpoint
from test_torch_pickle import INIT_ARGS, INIT_KW, _dumps, _generator_flat, _modules
from _torch_threads import torch_threads  # noqa: F401  (autouse)


def _names(d):
    return sorted(os.listdir(d))


def _image(path):
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image
    return np.asarray(Image.open(path))


def test_shape_files_match_jax_bytes(tmp_path):
    """save_mrc and save_mesh_ply write JAX's bytes for the same arrays: a
    random volume, and marching tetrahedra's faces of it (index space and
    the normalised (F, 3, 3) soup, with a voxel origin and scale)."""
    rng = np.random.RandomState(0)
    vol = (rng.randn(12, 12, 12) + 0.3).astype(np.float32)
    packed, n_faces, _ = marching_tetrahedra_faces(torch.tensor(vol), 0.5, 4096,
                                                   two_stage=False)
    assert n_faces > 100
    index = packed.reshape(-1, 3, 3).numpy()
    soup = index / np.float32(12) - np.float32(0.5)
    for name, fn_port, fn_jax in (
            ("vol.mrc", lambda p: shape_export.save_mrc(p, vol, voxel_size=0.5),
             lambda p: jshape_export.save_mrc(p, vol, voxel_size=0.5)),
            ("soup.ply", lambda p: shape_export.save_mesh_ply(p, soup, n_faces),
             lambda p: jshape_export.save_mesh_ply(p, soup, n_faces)),
            ("index.ply", lambda p: shape_export.save_mesh_ply(
                p, index, n_faces - 7, voxel_origin=(1.0, -2.0, 0.5), scale=0.25),
             lambda p: jshape_export.save_mesh_ply(
                p, index, n_faces - 7, voxel_origin=(1.0, -2.0, 0.5), scale=0.25))):
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        fn_port(str(a))
        fn_jax(str(b))
        assert a.read_bytes() == b.read_bytes(), name


def test_gen_videos_proj_matches_jax(tmp_path):
    """The same two projected_w.npz keyframes and pickle through both apps
    (sweep mode, 2 frames): trajectory.npy within 1e-6, the same frame
    files; the port's frames finite and of the SR's size. Then --finetuned
    on a generator checkpoint, image_mode image_depth, orbit mode."""
    gen, flat = _generator_flat()
    g = _modules(flat, class_name="TriPlaneGenerator", init_args=INIT_ARGS, init_kwargs=INIT_KW)
    pkl = tmp_path / "network.pkl"
    pkl.write_bytes(_dumps({"G_ema": g}))
    rng = np.random.RandomState(1)
    keys = []
    for i in range(2):
        keys.append(str(tmp_path / f"w{i}.npz"))
        w = rng.randn(1, gen.num_ws, 512).astype(np.float32) * 0.5
        np.savez(keys[-1], w=w if i == 0 else w[0])
    common = ["--latents", ",".join(keys), "--network_pkl", str(pkl), "--mode", "sweep",
              "--w_frames", "1", "--neural_rendering_resolution", "32", "--force_cpu"]
    out = gen_videos_proj.main(common + ["--outdir", str(tmp_path / "port")])
    jgen_videos_proj.main(common + ["--outdir", str(tmp_path / "jax")])
    assert _names(tmp_path / "port") == _names(tmp_path / "jax")
    traj, jtraj = np.load(out["trajectory"]), np.load(tmp_path / "jax" / "trajectory.npy")
    assert traj.shape == (2, 16)
    np.testing.assert_allclose(traj, jtraj, atol=1e-6)
    assert np.isfinite(_image(out["frames"][1]).astype(np.float32)).all()
    assert _image(out["frames"][0]).shape == (128, 128, 3)

    ck = str(tmp_path / "G_checkpoint")
    checkpoint.save(ck, gen.state_dict(), configs={"G": gen.config})
    out = gen_videos_proj.main(["--latents", keys[0], "--finetuned", ck, "--mode", "orbit",
                                "--w_frames", "2", "--image_mode", "image_depth",
                                "--neural_rendering_resolution", "16", "--force_cpu",
                                "--outdir", str(tmp_path / "ft")])
    frames = [_image(f) for f in out["frames"]]
    assert len(frames) == 2 and frames[0].shape == (16, 16, 3)
    assert frames[0].min() == 0 and frames[0].max() == 255   # depth scaled to [-1, 1]
    assert not np.allclose(np.load(out["trajectory"])[0], np.load(out["trajectory"])[1])


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """decoder_final of a one-step --smoke run of the port's trainer."""
    out = train_decoder.main(["--random_init", "--smoke", "--force_cpu", "--num_iter", "1",
                              "--eval_steps", "0",
                              "--outdir", str(tmp_path_factory.mktemp("train"))])
    return os.path.join(out["outdir"], "decoder_final")


def test_gen_shapes_on_trainer_snapshot(snapshot, tmp_path):
    """gen_shapes --checkpoint: the frozen generator (t_mapping and
    bcg_synthesis loaded strictly) -> .mrc of the sigma grid, then at the
    grid's median a .ply whose face count is marching tetrahedra's."""
    base = ["--checkpoint", snapshot, "--shape_res", "16", "--force_cpu"]
    first = gen_shapes.main(base + ["--out", str(tmp_path / "a")])
    sig = first["sigmas"]
    assert tuple(sig.shape) == (16, 16, 16) and bool(torch.isfinite(sig).all())
    level = float(sig.median())
    out = gen_shapes.main(base + ["--level", repr(level), "--out", str(tmp_path / "b")])
    assert out["n_faces"] > 0 and out["n_dropped"] == 0
    assert _names(tmp_path) == ["a.mrc", "a.ply", "b.mrc", "b.ply"]
    assert (tmp_path / "a.mrc").read_bytes() == (tmp_path / "b.mrc").read_bytes()
    header = (tmp_path / "b.ply").read_bytes().split(b"end_header\n")[0].decode()
    assert f"element face {out['n_faces']}" in header


def test_gen_videos_both_backends(snapshot, tmp_path):
    """gen_videos on the trainer's snapshot, 2 seeds x 1 frame at 64^2 on
    each backend: finite frames, the JAX app's file names. Then a frame of
    the snapshot's decoder with pallas_mapping (apply's mapping through
    K1's wrapper) renders the same bits inside plain_kernels (the card's
    frame hold), which swaps its names back on leaving."""
    for backend in ("xla", "pallas"):
        d = tmp_path / backend
        out = gen_videos.main(["--checkpoint", snapshot, "--seeds", "0,1", "--frames_per_seed",
                               "1", "--image_size", "64", "--backend", backend, "--force_cpu",
                               "--outdir", str(d)])
        assert [os.path.basename(f).split(".")[0] for f in out["frames"]] == \
            ["frame_00000", "frame_00001"]
        for f in out["frames"]:
            img = _image(f)
            assert img.shape == (64, 64, 3) and img.std() > 0

    dec, configs = load_decoder(snapshot, device="cpu")
    dec.config = dataclasses.replace(dec.config, pallas_mapping=True)
    args = gen_videos.build_argparser().parse_args(
        ["--checkpoint", snapshot, "--image_size", "64", "--backend", "pallas"])
    zs = gen_videos.seed_latents([0, 1], configs["frozen_G"].z_dim)
    names = (heads.mapping_forward, heads.decode_heads, fast_raster.blend_tiles)
    with torch.no_grad():
        f = gen_videos.frame(dec, configs["frozen_G"], configs.get("target_cfg"), zs, 1, args)
        with plain_kernels():
            assert heads.mapping_forward is not names[0]
            g = gen_videos.frame(dec, configs["frozen_G"], configs.get("target_cfg"), zs, 1,
                                 args)
    assert (heads.mapping_forward, heads.decode_heads, fast_raster.blend_tiles) == names
    assert torch.equal(f.image, g.image) and float(f.image.std()) > 0


def test_gen_samples_and_interpolation_write_jax_files(tmp_path):
    """gen_samples --smoke --random_views 2 --shapes and gen_interpolation
    --smoke write the files the JAX apps write for the same flags; the grid
    is 3 rows x 3 views of the 16^2 raw image."""
    flags = ["--smoke", "--force_cpu", "--seeds", "0,1", "--random_views", "2", "--shapes",
             "--shape_res", "16"]
    out = gen_samples.main(flags + ["--outdir", str(tmp_path / "s")])
    jgen_samples.main(flags + ["--outdir", str(tmp_path / "js")])
    assert _names(tmp_path / "s") == _names(tmp_path / "js")
    assert len(out["images"]) == 4 and len(out["shapes"]) == 2
    assert all(np.isfinite(_image(p).astype(np.float32)).all() for p in out["images"])
    flags = ["--smoke", "--force_cpu", "--cuts", "0,2", "--neural_rendering_resolution", "16"]
    out = gen_interpolation.main(flags + ["--outdir", str(tmp_path / "i")])
    jgen_interpolation.main(flags + ["--outdir", str(tmp_path / "ji")])
    assert _names(tmp_path / "i") == _names(tmp_path / "ji")
    assert _image(out["image"]).shape == (3 * 16, 3 * 16, 3)
    assert tuple(out["grid"].shape) == (3, 48, 48) and bool(torch.isfinite(out["grid"]).all())
