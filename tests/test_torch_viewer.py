"""The port's live viewer (counterparts of ``tests/test_viewer.py``): it
serves the page, frames and stats, applies WASD and mouse input, and
resets accumulation on camera moves. It binds ``port=0``, so it never
shares a socket with another test."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.scene.loader import make_test_scene
from rayaccel_tpu_torch.utils.viewer import Viewer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def viewer():
    s = make_test_scene(viewport=(64, 64), max_depth=1)
    ctx = racc.create_context(racc.Configuration(wave_size=4096,
                                                 backend="mxu"),
                              device="cpu")
    cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                              s.viewport_width, s.viewport_height)
    r = racc.PathTracingRenderer(ctx, cam, s)
    v = Viewer(r, rng.PRNGKey(0), s.cam_up, port=0)
    t = threading.Thread(target=v.run, kwargs={"quiet": True}, daemon=True)
    t.start()
    # Wait for the first real frame to be published.
    deadline = time.time() + 120
    while time.time() < deadline and v.renderer.spp == 0:
        time.sleep(0.2)
    assert v.renderer.spp > 0
    assert v.port != 0
    yield v
    v.stop()
    t.join(timeout=120)
    assert not t.is_alive()


def _get(viewer, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{path}",
                                timeout=timeout) as r:
        return r.read()


def test_viewer_serves_page_and_frames(viewer):
    page = _get(viewer, "/")
    assert b"rayaccel_tpu live" in page
    png = _get(viewer, "/frame.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    stats = json.loads(_get(viewer, "/stats"))
    assert stats["spp"] >= 1


def test_viewer_camera_input_resets_accumulation(viewer):
    origin_before = viewer.renderer.camera.origin.copy()
    assert viewer.renderer.spp >= 1
    # Record the reset by wrapping clear(): polling spp for the dip after
    # the move can miss it on a fast frame.
    cleared = threading.Event()
    orig_clear = viewer.renderer.clear

    def record_clear():
        cleared.set()
        return orig_clear()

    viewer.renderer.clear = record_clear
    try:
        _get(viewer, "/input?key=w")
        deadline = time.time() + 60
        while time.time() < deadline:
            if not np.allclose(viewer.renderer.camera.origin,
                               origin_before):
                break
            time.sleep(0.1)
        assert not np.allclose(viewer.renderer.camera.origin,
                               origin_before)
        assert cleared.wait(60)
    finally:
        viewer.renderer.clear = orig_clear

    # Mouse look also moves the camera (the view direction changes).
    view_before = viewer.renderer.camera.view.copy()
    _get(viewer, "/input?yaw=80&pitch=0")
    deadline = time.time() + 60
    while time.time() < deadline:
        if not np.allclose(viewer.renderer.camera.view, view_before):
            break
        time.sleep(0.1)
    assert not np.allclose(viewer.renderer.camera.view, view_before)
