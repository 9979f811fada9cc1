"""Port parity for the GAN metrics (metrics/*) against the JAX package:
FID, KID and precision / recall from the same features (FID through
FeatureStats, KID and PR on the CPU device; 1e-6 relative, PR exactly);
InceptionV3's features and logits on the port's seeded weights carried
to JAX by its pytorch-fid loader and back (port/from_jax.load_param_tree,
bit for bit) at the smallest input the network takes, 75^2 unresized
(1e-4 of the largest value); the registry's names
and ppl2_wend on the same key stream (1e-6 relative); and one
decoder_image_batches frame of a small decoder on the CPU (plain
versions of every kernel) against JAX's frame with JAX's draws (PSNR >= 50
dB). The JAX side runs in float32, x64 off."""
import itertools
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.decoder.heads import GaussianDecoder as JDec
from gaussian_gan_decoder_tpu.decoder.target_pipeline import TargetSamplerConfig as JTargetCfg
from gaussian_gan_decoder_tpu.flagship import default_camera_params as jcam_params
from gaussian_gan_decoder_tpu.metrics import feature_stats as jfs
from gaussian_gan_decoder_tpu.metrics import frechet as jfrechet
from gaussian_gan_decoder_tpu.metrics import inception as jinception
from gaussian_gan_decoder_tpu.metrics import kernel as jkernel
from gaussian_gan_decoder_tpu.metrics import metric_main as jmm
from gaussian_gan_decoder_tpu.metrics import precision_recall as jprecision_recall
from gaussian_gan_decoder_tpu.models.triplane import TriPlaneGenerator as JGen
from gaussian_gan_decoder_tpu.port import torch_pickle as jpickle
from gaussian_gan_decoder_tpu_torch import metrics
from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetSamplerConfig
from gaussian_gan_decoder_tpu_torch.metrics import feature_stats, metric_main
from gaussian_gan_decoder_tpu_torch.models.triplane import TriPlaneGenerator
from gaussian_gan_decoder_tpu_torch.port.from_jax import load_param_tree
from _gan_draws import node, seq
from _jax_fast import jax_fast  # noqa: F401  (autouse)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

RK = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4,
      "c_gen_conditioning_zero": True}
GEN_KW = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=32, channel_base=512,
              channel_max=32)
SHAPE_RES, POINTS, NRR, IMG = 16, 1024, 32, 64


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def test_fid_kid_pr_match_jax():
    """FID through FeatureStats (two batches a side), KID and PR on 64
    fixed features a side: the port on the CPU device against JAX's numpy."""
    rng = np.random.RandomState(0)
    real = rng.randn(64, 32).astype(np.float32)
    gen = (rng.randn(64, 32) * 1.1 + 0.2).astype(np.float32)

    def fid(fs, frechet):
        stats = [fs.stats_for_iterator(iter(np.split(a, 2)), lambda x: x, 64) for a in (real, gen)]
        return frechet.fid_from_stats(*stats)
    ref_fid, got_fid = fid(jfs, jfrechet), fid(feature_stats, metrics.frechet)
    ref_kid = jkernel.kid_from_features(real, gen, num_subsets=20)
    got_kid = metrics.kid_from_features(real, gen, num_subsets=20, device="cpu")
    ref_pr = jprecision_recall(real, gen)
    got_pr = metrics.precision_recall(real, gen, device="cpu")
    print(f"FID {got_fid} vs {ref_fid}; KID {got_kid} vs {ref_kid}; PR {got_pr} vs {ref_pr}")
    assert abs(got_fid - ref_fid) <= 1e-6 * abs(ref_fid)
    assert abs(got_kid - ref_kid) <= 1e-6 * abs(ref_kid)
    assert got_pr == ref_pr


def test_inception_matches_jax():
    """InceptionV3 on the port's seeded weights, carried to JAX through JAX's
    pytorch-fid loader (load_torch_state_dict: the tree JAX's init makes)
    and that tree carried back (port/from_jax.load_param_tree) bit for
    bit: pool3 features at 75^2 (unresized) and the TF-class logits of the
    same features within 1e-4 of the largest value."""
    net = metrics.InceptionV3(generator=torch.Generator().manual_seed(0))
    jnet = jinception.InceptionV3()
    params = jnet.load_torch_state_dict({k: v.numpy() for k, v in net.state_dict().items()})
    back = metrics.InceptionV3()
    load_param_tree(back, jax.tree.map(np.asarray, params))
    assert all(torch.equal(v, back.state_dict()[k]) for k, v in net.state_dict().items())
    x = (np.random.RandomState(1).rand(2, 3, 75, 75) * 255).astype(np.float32)
    ref = jax.jit(lambda p, x: jnet.features(p, x, resize_input=False))(params, jnp.asarray(x))
    ref_logits = ref @ params["fc"]["weight"].T + params["fc"]["bias"]
    with torch.no_grad():
        got = back.features(torch.tensor(x), resize_input=False)
        got_logits = got @ back.fc.weight.T + back.fc.bias
    for name, g, r in (("features", got, ref), ("logits", got_logits, ref_logits)):
        err = _rel(g, r)
        print(f"Inception {name}: {err:.3e}")
        assert err <= 1e-4, (name, err)


def test_inception_state_dict_loads_strictly(tmp_path):
    """load_inception reads a pytorch-fid-named file strictly (with
    BatchNorm's num_batches_tracked, which it drops); logits = fc of the
    299^2 features."""
    net = metrics.InceptionV3(generator=torch.Generator().manual_seed(3))
    sd = dict(net.state_dict())
    sd.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(0)
               for k in sd if k.endswith("bn.running_var")})
    torch.save(sd, tmp_path / "pt_inception.pth")
    loaded = metrics.load_inception(str(tmp_path / "pt_inception.pth"), device="cpu")
    assert all(torch.equal(v, loaded.state_dict()[k]) for k, v in net.state_dict().items())
    x = torch.rand(1, 3, 40, 40) * 255
    with torch.no_grad():
        f = loaded.features(x)
        assert torch.allclose(loaded.logits(x), f @ loaded.fc.weight.T + loaded.fc.bias)
    with pytest.raises(RuntimeError, match="Missing key"):
        torch.save({k: v for k, v in sd.items() if not k.startswith("fc.")},
                   tmp_path / "bad.pth")
        metrics.load_inception(str(tmp_path / "bad.pth"), device="cpu")


def test_registry_and_ppl_match_jax():
    """The registry's metric names are JAX's; ppl2_wend on the same key
    stream, mapping, synthesis and distance within 1e-6 relative."""
    assert metrics.list_metrics() == jmm.list_metrics()
    rng = np.random.RandomState(4)
    A = rng.randn(8, 6).astype(np.float32) * 0.3
    B = rng.randn(6, 12).astype(np.float32) * 0.3
    cs = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    # eps 0.25: at 1e-2 the two libraries' f32 sin, one ulp apart, differ
    # by ~4e-6 of the distance / eps^2
    kw = dict(num_samples=12, batch_size=4, z_dim=8, c_dim=3, epsilon=0.25)
    ref = jmm.ppl2_wend(
        mapping_fn=lambda k, z, c: jnp.tanh(z @ A) + c.sum(1, keepdims=True),
        synthesis_fn=lambda w, c: jnp.sin(w @ B), dist_fn=lambda a, b: ((a - b) ** 2).sum(1),
        key=jax.random.PRNGKey(5), c_source=iter(cs), **kw)
    At, Bt = torch.tensor(A), torch.tensor(B)
    got = metrics.calc_metric(
        "ppl2_wend", real_batches=None, gen_batches=None,
        mapping_fn=lambda k, z, c: torch.tanh(z @ At) + c.sum(1, keepdim=True),
        synthesis_fn=lambda w, c: torch.sin(w @ Bt),
        dist_fn=lambda a, b: ((a - b) ** 2).sum(1), key=np.asarray(jax.random.PRNGKey(5)),
        c_source=iter(cs), device="cpu", **kw)["results"]
    print(f"ppl2_wend {got['ppl2_wend']} vs {ref['ppl2_wend']}")
    assert abs(got["ppl2_wend"] - ref["ppl2_wend"]) <= 1e-6 * abs(ref["ppl2_wend"])


def test_decoder_image_batches_frame_matches_jax():
    """One decoder-FID frame of a small decoder (the port's seeded weights
    carried to JAX through the JAX package's reference-name loaders; density
    bias 0.3 so the surface sits inside the box) at the flagship camera: the
    port's plain path with JAX's target draws against JAX's frame, PSNR >= 50
    dB."""
    gen = TriPlaneGenerator(rendering_kwargs=RK, without_sr=True,
                            generator=torch.Generator().manual_seed(0), **GEN_KW)
    with torch.no_grad():
        gen.decoder.net[2].bias[0] = 0.3
    dec = GaussianDecoder(gen, gelu="exact", rng=torch.Generator().manual_seed(1)).eval()
    flat = {k: v.numpy() for k, v in dec.state_dict().items()}
    params = jpickle.decoder_head_params_from_state(flat)
    params["G"] = jpickle.generator_params_from_state(
        {k[2:]: v for k, v in flat.items() if k.startswith("G.")})
    jd = JDec(generator=JGen(without_sr=True, rendering_kwargs=tuple(RK.items()), **GEN_KW))
    tkw = dict(shape_res=SHAPE_RES, num_points=POINTS, mc_level=0.5, sigma_separable=True,
               face_capacity=12 * (SHAPE_RES - 1) ** 3, neural_rendering_resolution=NRR)
    cp, _ = jcam_params()
    cp = np.asarray(cp, np.float32)
    key = jax.random.PRNGKey(9)

    def frame(params, key):
        return next(jmm.decoder_image_batches(jd, params, params["G"], JTargetCfg(**tkw), key,
                                              itertools.repeat(cp), image_size=IMG))
    # JAX's stream traced into one program (its last step, np.asarray of the
    # frame, is the identity while tracing): eagerly it compiles ~750
    # programs, one an operation
    with mock.patch.object(jmm, "np", types.SimpleNamespace(asarray=lambda x: x)):
        ref = jax.jit(frame)(params, key)
    _, _, k_render, k_surf = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, 0), 1),
                                              4)
    draws = node(frame0=node(render=seq(k_render, 2), surface=seq(k_surf, 3)))
    got = next(metric_main.decoder_image_batches(
        dec, dec.G, TargetSamplerConfig(**tkw), np.asarray(key), itertools.repeat(cp),
        image_size=IMG, draws=draws))
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (1, 3, IMG, IMG) and ref.std() > 1.0
    mse = float(np.mean((got.numpy() / 255.0 - ref / 255.0) ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-30))
    print(f"decoder_image_batches frame vs JAX: PSNR {psnr:.1f} dB")
    assert psnr >= 50.0, psnr
