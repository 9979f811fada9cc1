"""The port's tile rasterizer at SH degree 3, its capped pair expansion and
the remote viewer's protocol, against the JAX package's, on the CPU.

About 300 seeded Gaussians with degree-3 SH features on a 64^2 frame, the
port's camera built from the JAX camera's own matrices, float32 on both
sides. rasterize: render within rtol 1e-5 and atol 1e-6, radii and
n_dropped equal; the gradients of a seeded cotangent on the render with
respect to means, scales, rotations, opacities, SH features and
means2d_offset (the screen-space gradient the densifier reads) each within
1e-5 of that input's largest gradient (the same sums in the same order up
to f32 rounding). Under a max_pairs below the pairs requested, the same
holds, n_dropped > 0, and the expansion builds exactly max_pairs pair
indices. The viewer's camera from one message equals JAX's bit for bit."""
import json
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_gan_decoder_tpu.gaussians.cameras import make_camera as jmake_camera
from gaussian_gan_decoder_tpu.gaussians.network_gui import NetworkGUI as JNetworkGUI
from gaussian_gan_decoder_tpu.splat.rasterize import RasterizeConfig as JRCfg
from gaussian_gan_decoder_tpu.splat.rasterize import rasterize as jrasterize
from gaussian_gan_decoder_tpu_torch.gaussians.cameras import Camera
from gaussian_gan_decoder_tpu_torch.gaussians.network_gui import NetworkGUI
from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig, rasterize
from _torch_threads import torch_threads  # noqa: F401  (autouse)

SIZE, N = 64, 300
NAMES = ("means", "scales", "rotations", "opacities", "shs", "offset")


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):
        yield


def _cameras():
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.diag([-1.0, 1.0, -1.0])
    c2w[2, 3] = 2.7
    jc = jmake_camera(SIZE, 0.227, jnp.asarray(c2w))
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    return jc, Camera(t(jc.world_view_transform), t(jc.full_proj_transform),
                      t(jc.camera_center), float(jc.tanfovx), float(jc.tanfovy), SIZE, SIZE)


def _inputs(seed):
    """means, scales, rotations, opacities, shs (N, 16, 3), offset zeros."""
    rng = np.random.RandomState(seed)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return (f((rng.rand(N, 3) - 0.5) * 0.4), f(np.exp(rng.randn(N, 3) * 0.3 - 3.5)),
            f(rng.randn(N, 4)), f(1.0 / (1.0 + np.exp(-rng.randn(N)))),
            f(rng.randn(N, 16, 3) * 0.5), np.zeros((N, 2), np.float32))


def _hold(cfg_kw, seed):
    jc, cam = _cameras()
    g = _inputs(seed)
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    cot = np.random.RandomState(seed + 100).randn(3, SIZE, SIZE).astype(np.float32)
    jcfg = JRCfg(tile_size=16, **cfg_kw)

    def jrender(m, s, r, o, shs, off):
        out = jrasterize(jc, m, s, r, o, shs=shs, sh_degree=3, bg=jnp.asarray(bg), config=jcfg,
                         means2d_offset=off)
        return out["render"], (out["radii"], out["n_dropped"])

    jimg, vjp, (jradii, jdrop) = jax.vjp(jax.jit(jrender), *(jnp.asarray(a) for a in g),
                                         has_aux=True)
    jgrads = jax.jit(vjp)(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in g]
    out = rasterize(cam, *ts[:4], shs=ts[4], sh_degree=3, bg=torch.tensor(bg),
                    config=RasterizeConfig(**cfg_kw), means2d_offset=ts[5])
    np.testing.assert_allclose(out["render"].detach().numpy(), np.asarray(jimg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(out["radii"].numpy(), np.asarray(jradii))
    assert out["n_dropped"] == int(jdrop)
    out["render"].backward(torch.tensor(cot))
    for name, t, jg in zip(NAMES, ts, jgrads):
        jg = np.asarray(jg)
        err = np.abs(t.grad.numpy() - jg).max() / np.abs(jg).max()
        print(f"{cfg_kw} d{name}: {err:.2e} of the largest")
        assert err <= 1e-5 and np.abs(jg).max() > 0, (name, err)
    assert float(out["render"].std()) > 0.02
    return out


def test_rasterize_sh3_matches_jax():
    out = _hold(dict(), 0)
    assert out["n_dropped"] == 0


def test_capped_expansion_matches_jax(monkeypatch):
    """max_pairs below the request: JAX's n_dropped, render and gradients,
    with no more than max_pairs pair indices built."""
    sizes = []
    real = torch.repeat_interleave

    def spy(*a, **kw):
        r = real(*a, **kw)
        sizes.append((kw.get("output_size"), r.numel()))
        return r

    monkeypatch.setattr(torch, "repeat_interleave", spy)
    out = _hold(dict(max_pairs=900, tile_capacity=64, chunk=32), 1)
    assert out["n_dropped"] > 0
    assert sizes == [(900, 900)], sizes


def test_network_gui_camera_matches_jax():
    """One SIBR message to the port's listener and to JAX's: the same
    camera, and the port's reply on the wire."""
    rng = np.random.RandomState(5)
    view = np.eye(4)
    view[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    view[3, :3] = rng.randn(3)
    msg = {"resolution_x": 32, "resolution_y": 16, "train": True, "fov_x": 0.5, "fov_y": 0.4,
           "z_near": 0.01, "z_far": 10.0, "shs_python": False, "rot_scale_python": False,
           "keep_alive": True, "scaling_modifier": 1.5,
           "view_matrix": view.reshape(-1).tolist(),
           "view_projection_matrix": rng.randn(16).tolist()}
    blob = json.dumps(msg).encode()
    cams = {}
    for name, cls in (("port", NetworkGUI), ("jax", JNetworkGUI)):
        gui = cls("127.0.0.1", 0)
        port = gui.listener.getsockname()[1]
        res = {}

        def server():
            while gui.conn is None:
                gui.try_connect()
            res["r"] = gui.receive()
            gui.send(np.full((16, 32, 3), 7, np.uint8).tobytes(), "ok")

        th = threading.Thread(target=server, daemon=True)
        th.start()
        cli = socket.create_connection(("127.0.0.1", port))
        cli.sendall(len(blob).to_bytes(4, "little") + blob)
        img = b""
        while len(img) < 16 * 32 * 3:
            img += cli.recv(16 * 32 * 3 - len(img))
        n = int.from_bytes(cli.recv(4), "little")
        assert cli.recv(n).decode() == "ok" and img[0] == 7
        th.join(timeout=5)
        cli.close()
        gui.listener.close()
        cam, train, keep, smod, wh, _ = res["r"]
        assert (train, keep, smod, wh) == (True, True, 1.5, (32, 16))
        cams[name] = cam
    pc, jc = cams["port"], cams["jax"]
    for f in ("world_view_transform", "full_proj_transform", "camera_center"):
        np.testing.assert_array_equal(getattr(pc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    # JAX keeps the tangents weakly typed: they enter its f32 projection as f32
    assert pc.tanfovx == float(np.float32(jc.tanfovx))
    assert pc.tanfovy == float(np.float32(jc.tanfovy))
    assert (pc.image_width, pc.image_height) == (32, 16)
