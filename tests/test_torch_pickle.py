"""The port's reference-pickle loaders (port/torch_pickle.py) against the
JAX package's, on pickles the test builds itself as
torch_utils.persistence would (a shim module stands in for the reference's
persistence at pickling time, as in tests/test_port.py): a GAN snapshot's
G_ema and a decoder snapshot with its embedded G. The states must equal
what JAX's loaders give, converted by port/torch_export, bit for bit, and
load strictly into the port's modules. The trainer's --network_pkl runs one
step from such a pickle."""
import contextlib
import io
import json
import math
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.port import torch_pickle as jpickle
from gaussian_gan_decoder_tpu.port.torch_export import (
    decoder_state_dict, generator_state_from_params)
from gaussian_gan_decoder_tpu_torch.apps import train_decoder
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.surface import sigma_grid_separable
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.port import torch_pickle
from _torch_threads import torch_threads  # noqa: F401  (autouse)

# a tiny PanoHead generator with the 2x super-resolution stack (w_dim 512,
# as the stack's blocks take), so --network_pkl trains at 128^2
RK = {"triplane_size": 16, "triplane_depth": 3, "depth_resolution": 4,
      "depth_resolution_importance": 4, "c_gen_conditioning_zero": True,
      "avg_camera_pivot": [0.0, 0.0, 0.2], "ray_start": "auto", "ray_end": "auto",
      "superresolution_module": "training.superresolution.SuperresolutionHybrid2X"}
INIT_ARGS = (32, 25, 512, 128, 3)   # z_dim, c_dim, w_dim, img_resolution, img_channels
INIT_KW = {"rendering_kwargs": RK, "channel_base": 512, "channel_max": 32,
           "num_fp16_res": 0, "sr_num_fp16_res": 0, "mapping_kwargs": {}}


def _reconstruct_persistent_obj(meta):  # never called: the unpicklers intercept it
    raise RuntimeError("the reference's reconstructor must not run")


_reconstruct_persistent_obj.__module__ = "torch_utils.persistence"


class _Persistent:
    """Pickles as a torch_utils.persistence-wrapped module does."""

    def __init__(self, tensors=None, modules=None, class_name="training.x.Y", init_args=(),
                 init_kwargs=None, extra=None):
        self.tensors, self.modules = dict(tensors or {}), dict(modules or {})
        self.class_name, self.init_args = class_name, init_args
        self.init_kwargs, self.extra = dict(init_kwargs or {}), dict(extra or {})

    def __reduce__(self):
        state = {"_parameters": self.tensors, "_buffers": {}, "_modules": self.modules,
                 "_init_args": self.init_args, "_init_kwargs": self.init_kwargs, **self.extra}
        return (_reconstruct_persistent_obj, (dict(
            type="class", version=6, module_src="raise RuntimeError('embedded source ran')",
            class_name=self.class_name, state=state),))


@contextlib.contextmanager
def _persistence_shim():
    pkg, mod = types.ModuleType("torch_utils"), types.ModuleType("torch_utils.persistence")
    mod._reconstruct_persistent_obj = _reconstruct_persistent_obj
    pkg.persistence = mod
    saved = {k: sys.modules.get(k) for k in ("torch_utils", "torch_utils.persistence")}
    sys.modules.update({"torch_utils": pkg, "torch_utils.persistence": mod})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _modules(flat, **kw):
    """Flat dotted names -> nested _Persistent modules."""
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.as_tensor(v)

    def build(node, **kw):
        return _Persistent({k: v for k, v in node.items() if torch.is_tensor(v)},
                           {k: build(v) for k, v in node.items() if isinstance(v, dict)}, **kw)
    return build(tree, **kw)


def _generator_flat():
    """The generator's reference-named weights as a reference snapshot
    holds them: the port's state, plus t_mapping (not ported, dropped on
    load) and a resample filter (config in both packages, dropped)."""
    gen = TriPlaneGenerator(*INIT_ARGS, **INIT_KW, generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    flat = {k: v.clone() for k, v in gen.state_dict().items()}
    flat["t_mapping.fc0.weight"] = torch.tensor(rng.randn(64, 57).astype(np.float32))
    flat["backbone.synthesis.b8.resample_filter"] = torch.ones(4, 4)
    # non-zero noise strengths, so their bits are checked too
    for k in flat:
        if k.endswith("noise_strength"):
            flat[k] = torch.tensor(rng.randn(), dtype=torch.float32)
    return gen, flat


def _dumps(obj):
    with _persistence_shim():
        return pickle.dumps(obj)


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    gen, flat = _generator_flat()
    g = _modules(flat, class_name="TriPlaneGenerator", init_args=INIT_ARGS,
                 init_kwargs=INIT_KW)
    d = tmp_path_factory.mktemp("pkl")
    gpath = str(d / "network.pkl")
    with open(gpath, "wb") as f:
        f.write(_dumps({"G_ema": g, "D": None, "training_set_kwargs": {"resolution": 128}}))
    dec = GaussianDecoder(gen, gelu="exact", rng=torch.Generator().manual_seed(2))
    heads = {k: v for k, v in dec.state_dict().items() if not k.startswith("G.")}
    dstub = _modules(heads, class_name="SequentialDecoderReverse",
                     extra={"hidden_dim": 128, "use_xyz_embedding": False,
                            "use_gen_finetune": True})
    dstub.modules["G"] = g
    dpath = str(d / "decoder.pkl")
    with open(dpath, "wb") as f:
        f.write(_dumps({"decoder": dstub, "dataloader": None}))
    return gpath, dpath, flat, dec


def test_load_generator_pkl_matches_jax(pickles):
    gpath, _, flat, _ = pickles
    gen, state = torch_pickle.load_generator_pkl(gpath, device="cpu")
    jcfg, jparams = jpickle.load_generator_pkl(gpath)
    ref = generator_state_from_params(jparams)
    assert set(state) == set(ref) and "t_mapping.fc0.weight" in state
    assert not any(k.endswith("resample_filter") for k in state)
    for k, v in ref.items():
        assert state[k].dtype == np.float32 and np.array_equal(state[k], v), k
    own = gen.state_dict()
    assert set(own) == {k for k in state if not k.startswith("t_mapping.")}
    assert all(torch.equal(own[k], torch.as_tensor(flat[k])) for k in own)
    c = gen.config
    assert (c.z_dim, c.c_dim, c.w_dim, c.img_resolution, c.channel_base, c.channel_max) == (
        jcfg.z_dim, jcfg.c_dim, jcfg.w_dim, jcfg.img_resolution, jcfg.channel_base,
        jcfg.channel_max)
    assert dict(c.rendering_kwargs) == dict(jcfg.rendering_kwargs)
    assert gen.rk["avg_camera_pivot"] == (0.0, 0.0, 0.2)


def test_load_decoder_pkl_matches_jax(pickles):
    _, dpath, flat, dec = pickles
    loaded, state = torch_pickle.load_decoder_pkl(dpath, device="cpu")
    jcfg, jparams = jpickle.load_decoder_pkl(dpath)
    ref = decoder_state_dict(jcfg, jparams)
    assert set(state) == set(ref) and jcfg.decoder_type == "sequential_reversed"
    for k, v in ref.items():
        assert np.array_equal(state[k], v), k
    assert loaded.gelu == "exact"
    for k, v in loaded.state_dict().items():
        want = flat[k[2:]] if k.startswith("G.") else dec.state_dict()[k]
        assert torch.equal(v, torch.as_tensor(want)), k


def test_unpickler_is_inert_and_unported_kinds_raise(pickles):
    """The embedded source never runs and reference-internal symbols
    resolve to inert dicts; a generator whose rendering kwargs have depth 1
    reads as an EG3D tri-plane; a decoder class the reference does not have
    raises, and so does a decoder whose recorded xyz embedding disagrees
    with its heads' widths (the strict load: every decoder class, width and
    embedding of the reference loads, tests/test_torch_decoder_types.py)."""
    data = torch_pickle.load_reference_pickle(pickles[0])
    assert isinstance(data["G_ema"], torch_pickle.PersistentStub)
    assert data["training_set_kwargs"] == {"resolution": 128}

    class EasyDict(dict):   # pickles as the reference's dnnlib.util.EasyDict
        pass
    EasyDict.__module__, EasyDict.__qualname__ = "dnnlib.util", "EasyDict"
    got = torch_pickle.load_reference_pickle(io.BytesIO(_dumps_ref(EasyDict(a=1))))
    assert type(got) is torch_pickle._EasyDict and got == {"a": 1} and got.a == 1

    stub = torch_pickle.PersistentStub({"state": {"_init_kwargs": {
        "rendering_kwargs": {"triplane_depth": 1}}}})
    cfg = torch_pickle.generator_config_from_pickle(stub)
    assert cfg.variant == "eg3d" and dict(cfg.rendering_kwargs) == {"triplane_depth": 1}
    d = torch_pickle.load_reference_pickle(pickles[1])["decoder"]
    d.state["use_xyz_embedding"] = True
    with pytest.raises(RuntimeError, match="size mismatch"):
        torch_pickle.load_decoder_pkl({"decoder": d}, device="cpu")
    d.state["use_xyz_embedding"] = False
    d.class_name = "training.decoder.OtherDecoder"
    with pytest.raises(ValueError, match="unknown decoder class"):
        torch_pickle.load_decoder_pkl({"decoder": d}, device="cpu")


def _dumps_ref(obj):
    with _persistence_shim():
        sys.modules.setdefault("dnnlib", types.ModuleType("dnnlib"))
        util = types.ModuleType("dnnlib.util")
        util.EasyDict = type(obj)
        saved = sys.modules.get("dnnlib.util")
        sys.modules["dnnlib.util"] = util
        try:
            return pickle.dumps(obj)
        finally:
            if saved is None:
                sys.modules.pop("dnnlib.util", None)
            else:
                sys.modules["dnnlib.util"] = saved


def test_network_pkl_trains_one_step(pickles, tmp_path):
    """apps/train_decoder --network_pkl on the CPU, shapes cut down (256
    points, 16^3 sigma grid, 128^2 image; the marching level the 0.9
    quantile of the first latent's sigma grid): one finite step, and the
    final snapshot's frozen generator holds the pickle's weights."""
    gpath, _, flat, _ = pickles
    gen, _ = torch_pickle.load_generator_pkl(gpath, device="cpu")
    with torch.no_grad():
        z = torch.randn((1, 32), generator=torch.Generator().manual_seed(304))
        ws = gen.mapping(z, torch.zeros((1, 25)))
        sig = sigma_grid_separable(gen, gen.synthesis_planes(ws), shape_res=16)
    level = float(torch.quantile(sig.flatten(), 0.9))
    out = train_decoder.main(["--network_pkl", gpath, "--force_cpu", "--num_iter", "1",
                              "--num_points", "256", "--shape_res", "16", "--image_size", "128",
                              "--mc_level", repr(level), "--eval_steps", "0",
                              "--outdir", str(tmp_path)])
    loss = out["last_metrics"]["Loss/total"]
    assert math.isfinite(loss) and loss > 0 and out["last_metrics"]["General/n_pairs"] > 0
    with open(os.path.join(out["outdir"], "stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[0]["step"] == 0 and rows[-1] == {"final_eval": {}}
    snap = torch.load(os.path.join(out["outdir"], "decoder_final"), weights_only=True)
    assert all(torch.equal(v, torch.as_tensor(flat[k])) for k, v in snap["frozen_G"].items())
