"""Remote-viewer TCP protocol (SIBR / splatviz compatible) — port of
gaussians/network_gui.py, the camera built as torch tensors.

Re-design of the reference's gaussian_splatting/gaussian_renderer/
network_gui.py:26-86: a non-blocking TCP listener; the viewer sends a
length-prefixed JSON message with camera matrices + flags, the trainer
replies with raw RGB bytes + a length-prefixed verify string.

The wire format is kept byte-identical so the reference's SIBR remote
viewer / splatviz can connect to THIS trainer:
  recv: [u32 little len][json {resolution_x/y, train, fov_x/y, z_near/far,
        shs_python, rot_scale_python, keep_alive, scaling_modifier,
        view_matrix (16f), view_projection_matrix (16f)}]
  send: [H*W*3 u8 image][u32 little len][ascii verify]
"""
from __future__ import annotations

import json
import math
import socket
import traceback
from typing import Optional

import numpy as np
import torch

from .cameras import Camera


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009, device=None):
        self.device = device
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"viewer connected: {addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout):
            pass

    def _read(self) -> dict:
        n = int.from_bytes(self.conn.recv(4), "little")
        buf = b""
        while len(buf) < n:
            buf += self.conn.recv(n - len(buf))
        return json.loads(buf.decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def receive(self):
        """-> (Camera | None, do_training, keep_alive, scaling_modifier,
        (width, height), msg). Returns Nones on a zero-size request.

        msg is the raw decoded JSON: clients MAY extend the base SIBR
        message with renderer-state keys (seed blending, stylemix,
        truncation, render_type); the base wire format stays byte-identical
        to the reference's. The camera's tensors lie on the device given
        at construction; its tangents are f32 values, as the JAX one's."""
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, (0, 0), msg
        try:
            view = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
            view[:, 1] = -view[:, 1]
            view[:, 2] = -view[:, 2]
            proj = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
            proj[:, 1] = -proj[:, 1]
            t = lambda a: torch.tensor(np.asarray(a, np.float32), device=self.device)  # noqa: E731
            cam = Camera(
                world_view_transform=t(view), full_proj_transform=t(proj),
                camera_center=t(np.linalg.inv(view)[3, :3]),
                tanfovx=float(np.float32(math.tan(msg["fov_x"] * 0.5))),
                tanfovy=float(np.float32(math.tan(msg["fov_y"] * 0.5))),
                image_width=width, image_height=height)
        except Exception:
            traceback.print_exc()
            raise
        return (cam, bool(msg["train"]), bool(msg["keep_alive"]),
                float(msg["scaling_modifier"]), (width, height), msg)
