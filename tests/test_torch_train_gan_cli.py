"""The port's train_gan app, its dataset and its GAN-snapshot loader:
the --smoke CLI on the synthetic stream and on a dataset zip, writing
stats.jsonl, fakes and snapshots, and a --resume of its snapshot that
restores the whole train state bit for bit; data/dataset.py against the
JAX package's on a zip and a directory the test writes (images, labels,
the yaw-flipped label, the pose filter, the sampler, batches: bit for
bit); the reference GAN pickle loader against JAX's (bit for bit), and
--resume from such a pickle; and, on the JAX side, that its train_gan's
jitted step never sees the ADA p that the app updates."""
import io
import json
import math
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaussian_gan_decoder_tpu.data import dataset as jdataset
from gaussian_gan_decoder_tpu.port import torch_pickle as jpickle
from gaussian_gan_decoder_tpu.port.torch_export import flatten_params, generator_state_from_params
from gaussian_gan_decoder_tpu_torch.apps import train_gan
from gaussian_gan_decoder_tpu_torch.data import dataset as tdataset
from gaussian_gan_decoder_tpu_torch.port import torch_pickle
from gaussian_gan_decoder_tpu_torch.train import gan
from test_torch_pickle import _dumps, _modules
from _torch_threads import torch_threads  # noqa: F401  (autouse)

SMOKE = ["--smoke", "--force_cpu", "--batch", "2"]


def _label(yaw, pitch=0.0, radius=2.7):
    """A 25-value camera label: a cam2world looking at the origin from
    (yaw, pitch), and EG3D's normalised intrinsics."""
    eye = radius * np.array([math.sin(yaw) * math.cos(pitch), math.sin(pitch),
                             math.cos(yaw) * math.cos(pitch)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, -up, fwd, eye
    return pose.reshape(-1).tolist() + [4.2647, 0, 0.5, 0, 4.2647, 0.5, 0, 0, 1]


def _write_dataset(root, n=6, size=20):
    """imgs.zip (RGB PNGs + dataset.json), segs.zip (grey PNGs) and the same
    images as a directory, at yaws from frontal to the back of the head."""
    from PIL import Image

    rng = np.random.RandomState(0)
    yaws = np.linspace(0.0, 2.9, n)
    names = [f"img{i:05d}.png" for i in range(n)]
    labels = {"labels": [[nm, _label(y, 0.05 * i)] for i, (nm, y) in enumerate(zip(names, yaws))]}
    os.makedirs(os.path.join(root, "dir"), exist_ok=True)

    def png(arr, mode):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG")
        return buf.getvalue()

    with zipfile.ZipFile(os.path.join(root, "imgs.zip"), "w") as zi, \
            zipfile.ZipFile(os.path.join(root, "segs.zip"), "w") as zs:
        for nm in names:
            data = png(rng.randint(0, 256, (size, size, 3), dtype=np.uint8), "RGB")
            zi.writestr(nm, data)
            with open(os.path.join(root, "dir", nm), "wb") as f:
                f.write(data)
            zs.writestr(nm, png(rng.randint(0, 256, (size, size), dtype=np.uint8), "L"))
        zi.writestr("dataset.json", json.dumps(labels))
    with open(os.path.join(root, "dir", "dataset.json"), "w") as f:
        json.dump(labels, f)
    return os.path.join(root, "imgs.zip"), os.path.join(root, "segs.zip"), os.path.join(root, "dir")


def _same_state(a, b):
    assert a.step == b.step and a.cur_nimg == b.cur_nimg
    for name in ("G", "D", "G_ema"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
    for name in ("g_opt", "d_opt"):
        sa, sb = getattr(a, name).state_dict()["state"], getattr(b, name).state_dict()["state"]
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k][m], sb[k][m]) for k in sa for m in sa[k]), name


def test_cli_smoke_snapshot_and_resume(tmp_path):
    """Two PanoHead steps with the fixed augment: stats rows with every
    loss (R1 > 0 on step 0), fakes_init / fakes_final, snapshot_final and its
    configs; --resume of the snapshot restores G, D, G_ema, both Adams,
    step and cur_nimg bit for bit, and a resumed run goes on from step 2."""
    out = train_gan.main(SMOKE + ["--kimg", "0.004", "--aug", "fixed", "--ada_p", "0.2",
                                  "--outdir", str(tmp_path / "a")])
    assert out["steps"] == 2 and out["state"].step == 2
    rows = [json.loads(r) for r in open(tmp_path / "a" / "stats.jsonl")]
    assert rows[0]["Loss/r1_penalty"] > 0 and rows[0]["Loss/G/reg"] > 0
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert {os.path.basename(p) for p in out["fakes"]} == {"fakes_init.png", "fakes_final.png"}
    snap = str(tmp_path / "a" / "snapshot_final")
    assert out["snapshots"] == [snap] and os.path.isfile(snap + ".config.json")

    args = train_gan.build_argparser().parse_args(SMOKE)
    G, D, G_ema, nrr = train_gan.build_networks(args, "cpu")
    fresh = gan.init_gan_state(G, D, G_ema, train_gan.loss_config(args, nrr))
    _same_state(train_gan.resume(snap, fresh), out["state"])
    out2 = train_gan.main(SMOKE + ["--kimg", "0.002", "--resume", snap,
                                   "--outdir", str(tmp_path / "b")])
    assert out2["state"].step == 3


def test_cli_on_dataset_zip(tmp_path):
    """EG3D and PanoHead --smoke on an image zip (+ a segmentation zip):
    one step each from the dataset, finite losses."""
    imgs, segs, _ = _write_dataset(str(tmp_path))
    for name, flags in (("eg3d", ["--variant", "eg3d", "--data", imgs]),
                        ("panohead", ["--data", imgs, "--seg_data", segs])):
        out = train_gan.main(SMOKE + ["--kimg", "0.002", "--outdir", str(tmp_path / name)]
                             + flags)
        rows = [json.loads(r) for r in open(tmp_path / name / "stats.jsonl")]
        assert out["state"].step == 1 and all(np.isfinite(v) for v in rows[0].values())


def test_dataset_matches_jax(tmp_path):
    """ImageFolderDataset (zip and directory, xflip), MaskLabeledDataset
    with the pose filter and back-view repeats, InfiniteSampler and
    batch_iterator, get_poseangle: equal to the JAX package's, bit for bit."""
    imgs, segs, folder = _write_dataset(str(tmp_path))
    for path in (imgs, folder):
        a = tdataset.ImageFolderDataset(path, resolution=16, xflip=True)
        b = jdataset.ImageFolderDataset(path, resolution=16, xflip=True)
        assert len(a) == len(b) == 12 and a.label_dim == b.label_dim == 25
        for i in range(len(a)):
            (ia, la), (ib, lb) = a[i], b[i]
            assert np.array_equal(ia, ib) and np.array_equal(la, lb)
    kw = dict(resolution=16, xflip=True, back_repeat=3, max_yaw=150.0)
    a, b = (tdataset.MaskLabeledDataset(imgs, segs, **kw),
            jdataset.MaskLabeledDataset(imgs, segs, **kw))
    assert len(a) == len(b) and np.array_equal(a._index, b._index) and len(a) != 12
    for i in range(len(a)):
        assert all(np.array_equal(x, y) for x, y in zip(a[i], b[i]))
    for lab in (a.images.get_label(3), a.images.get_label(8)):
        assert tdataset.get_poseangle(lab) == jdataset.get_poseangle(lab)
    sa, sb = (iter(tdataset.InfiniteSampler(len(a), seed=3)),
              iter(jdataset.InfiniteSampler(len(b), seed=3)))
    assert [next(sa) for _ in range(40)] == [next(sb) for _ in range(40)]
    ba = next(tdataset.batch_iterator(a, 4, tdataset.InfiniteSampler(len(a), seed=1)))
    bb = next(jdataset.batch_iterator(b, 4, jdataset.InfiniteSampler(len(b), seed=1)))
    assert all(np.array_equal(x, y) for x, y in zip(ba, bb))


def test_gan_pickle_matches_jax_and_resumes(tmp_path):
    """A reference GAN snapshot {G, G_ema, D (MaskDualDiscriminator),
    augment_pipe} built by the test: the port's load_gan_snapshot_pkl gives
    JAX's discriminator config and the same weights as JAX's loader, bit for
    bit; they load strictly, and train_gan --resume from the pickle runs."""
    args = train_gan.build_argparser().parse_args(SMOKE)
    G, D, G_ema, nrr = train_gan.build_networks(args, "cpu")
    g_flat = {k: v.clone() for k, v in G.state_dict().items()}
    d_flat = {k: v.clone() + 0.5 for k, v in D.state_dict().items()}
    d_flat["b16.resample_filter"] = torch.ones(4, 4)
    d_kw = {"channel_base": 256, "channel_max": 32, "num_fp16_res": 0, "conv_clamp": None,
            "epilogue_kwargs": {"mbstd_group_size": 2}}
    g_kw = {"rendering_kwargs": {"triplane_size": 16, "triplane_depth": 3,
                                 "depth_resolution": 4, "depth_resolution_importance": 4},
            "channel_base": 512, "channel_max": 32}
    snap = {"G": _modules(g_flat, class_name="training.triplane.TriPlaneGenerator",
                          init_args=(32, 25, 32, 32, 3), init_kwargs=g_kw),
            "G_ema": _modules({k: v * 2 for k, v in g_flat.items()},
                              class_name="training.triplane.TriPlaneGenerator",
                              init_args=(32, 25, 32, 32, 3), init_kwargs=g_kw),
            "D": _modules(d_flat, class_name="training.dual_discriminator.MaskDualDiscriminator",
                          init_args=(25, 16, 3, 8, 1), init_kwargs=d_kw),
            "augment_pipe": None}
    path = tmp_path / "network-snapshot.pkl"
    path.write_bytes(_dumps(snap))
    got = torch_pickle.load_gan_snapshot_pkl(str(path))
    ref = jpickle.load_gan_snapshot_pkl(str(path))
    jd = ref["D"]
    assert got["D"] == type(got["D"])(**{f: getattr(jd, f) for f in got["D"].__dataclass_fields__})
    ref_d = flatten_params(ref["d_params"])
    assert got["d_params"].keys() == ref_d.keys() == D.state_dict().keys()
    assert all(np.array_equal(got["d_params"][k], ref_d[k]) for k in ref_d)
    for name in ("g_params", "g_ema"):
        ref_g = generator_state_from_params(ref[name])
        assert got[name].keys() == ref_g.keys()
        assert all(np.array_equal(got[name][k], ref_g[k]) for k in ref_g)

    state = train_gan.resume(str(path), gan.init_gan_state(G, D, G_ema,
                                                           train_gan.loss_config(args, nrr)))
    assert all(torch.equal(state.D.state_dict()[k], torch.as_tensor(d_flat[k]))
               for k in state.D.state_dict())
    assert all(torch.equal(state.G_ema.state_dict()[k], 2 * g_flat[k]) for k in g_flat)
    out = train_gan.main(SMOKE + ["--kimg", "0.002", "--resume", str(path),
                                  "--outdir", str(tmp_path / "r")])
    assert out["state"].step == 1


def test_jax_train_gan_step_never_sees_ada_p(monkeypatch, tmp_path):
    """JAX's train_gan (read, not changed): its augment closure reads ada_p,
    the app updates ada_p every 4 steps, but the step is jax.jit-traced
    once, with the first p as a constant, so augment_pipe sees --ada_p alone
    while ada_update moves p. The networks, the state, the step's losses and
    the snapshot writer are stand-ins (only the app's wiring runs); the
    step's real-score metric is 1, so p rises."""
    from gaussian_gan_decoder_tpu.models import discriminator as jdisc
    from gaussian_gan_decoder_tpu.models import triplane as jtri
    from gaussian_gan_decoder_tpu.train import augment as jaug
    from gaussian_gan_decoder_tpu.train import checkpoint as jckpt
    from gaussian_gan_decoder_tpu.train import gan as jgan
    from gaussian_gan_decoder_tpu.apps import train_gan as japp

    class G:
        def __init__(self, **kw):
            self.z_dim, self.img_resolution = kw["z_dim"], kw["img_resolution"]

        def mapping(self, p, z, c):
            return z

        def synthesis(self, p, ws, c, neural_rendering_resolution):
            return {"image_raw": jnp.zeros((1, 3, 4, 4))}

    class D:
        def __init__(self, **kw):
            self.img_resolution = kw["img_resolution"]

    seen_p, ada = [], []
    real_update = jaug.ada_update

    def make_step(G, D, cfg, augment_fn=None):
        def step(state, key, z, c, real, real_c):
            out = augment_fn(key, real)
            return state, {"Loss/scores/real": 1.0 + 0.0 * jnp.mean(out["image"])}
        return step, None

    def pipe(key, images, p, cfg):
        seen_p.append(float(p))
        return images

    monkeypatch.setattr(jtri, "TriPlaneGenerator", G)
    monkeypatch.setattr(jdisc, "Discriminator", D)
    monkeypatch.setattr(jgan, "init_gan_state",
                        lambda key, G, D, cfg: jgan.GANTrainState(*(jnp.full((), float(i))
                                                                      for i in range(7))))
    monkeypatch.setattr(jgan, "make_gan_train_step", make_step)
    monkeypatch.setattr(jaug, "augment_pipe", pipe)
    monkeypatch.setattr(jaug, "ada_update", lambda *a, **k: ada.append(real_update(*a, **k))
                        or ada[-1])
    monkeypatch.setattr(jckpt, "save", lambda *a, **k: None)
    with jax.enable_x64(False):
        japp.main(["--smoke", "--force_cpu", "--kimg", "0.016", "--batch", "2", "--aug", "ada",
                   "--ada_p", "0.5", "--outdir", str(tmp_path)])
    assert len(ada) == 2 and float(ada[-1]) > float(ada[0]) > 0.5   # p moved on the host
    assert seen_p == [0.5]      # one trace of the step, with the first p
