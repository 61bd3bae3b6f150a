"""The port's app shell against the JAX package's: the counterparts of the
15 tests of ``tests/test_cli_and_utils.py`` run through
``rayaccel_tpu_torch.cli`` with ``--device cpu`` (same inputs, same bars),
the two CLIs' images through the two-class gate, checkpoints written by one
package and resumed by the other, the flag mapping and the parser."""

import itertools
import os
import types

import numpy as np
import pytest
import torch

import jax

from rayaccel_tpu import cli as jax_cli
from rayaccel_tpu.camera import Camera as JaxCamera
from rayaccel_tpu.scene.loader import make_test_scene as jax_test_scene
from rayaccel_tpu.utils import checkpoint as jax_ckpt

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import cli, rng
from rayaccel_tpu_torch.scene.loader import make_test_scene, save_scene
from rayaccel_tpu_torch.tools.oracle_lib import two_class_gate
from rayaccel_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint,
                                                 scene_fingerprint)
from rayaccel_tpu_torch.utils.image import rmse, tonemap
from rayaccel_tpu_torch.utils.stats import RenderStats

torch.set_num_threads(2)

SMALL = ["--width", "64", "--height", "64", "--wave-size", "4096"]


def cli_main(argv):
    return cli.main(list(argv) + ["--device", "cpu"])


def read_pfm(path):
    """(H, W, 3) float32 of a PFM written by ``write_pfm``."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"PF"
        w, h = map(int, f.readline().split())
        assert float(f.readline()) < 0            # little-endian
        return np.flipud(np.fromfile(f, np.float32).reshape(h, w, 3))


def _cpu_context():
    return racc.create_context(racc.Configuration(wave_size=4096),
                               device="cpu")


def _renderer(s, cam=None):
    cam = cam or racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up,
                                     s.cam_fov, 64, 64)
    return racc.PathTracingRenderer(_cpu_context(), cam, s)


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.bin")
    save_scene(path, make_test_scene(viewport=(64, 64)))
    return path


# ---- the counterparts of tests/test_cli_and_utils.py ----

def test_cli_conflicting_flags():
    assert cli_main(["--no-gpu", "--no-cpu-tracing"]) == 1


def test_cli_renders_png(tmp_path):
    out = str(tmp_path / "t.png")
    rc = cli_main(["--synthetic", "test", "--spp", "1", "--quiet",
                   "--max-depth", "1", *SMALL, "--out", out])
    assert rc == 0
    data = open(out, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(data) > 500


def test_cli_whitted_xla_backend(tmp_path):
    out = str(tmp_path / "w.pfm")
    rc = cli_main(["--synthetic", "test", "--whitted", "--no-gpu",
                   "--spp", "1", "--quiet", *SMALL, "--out", out])
    assert rc == 0
    with open(out, "rb") as f:
        assert f.readline().strip() == b"PF"


def test_scene_file_roundtrip_via_cli(tmp_path, scene_file):
    out = str(tmp_path / "s.png")
    rc = cli_main(["--scene", scene_file, "--spp", "1", "--quiet",
                   "--wave-size", "4096", "--max-depth", "1", "--out", out])
    assert rc == 0 and os.path.exists(out)


def test_checkpoint_roundtrip(tmp_path):
    s = make_test_scene(viewport=(64, 64), max_depth=1)
    r = _renderer(s)
    r.render_frame(rng.PRNGKey(0))
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, r, rng.PRNGKey(0))

    r2 = _renderer(s)
    key = load_checkpoint(ckpt + ".npz", r2)
    assert r2.spp == 1
    assert key == rng.PRNGKey(0)
    torch.testing.assert_close(r2.frame_buffer, r.frame_buffer, rtol=0,
                               atol=0)
    # Continuing from the checkpoint == continuing the original.
    r.render_frame(rng.PRNGKey(1))
    r2.render_frame(rng.PRNGKey(1))
    torch.testing.assert_close(r2.frame_buffer, r.frame_buffer, rtol=0,
                               atol=0)


def test_checkpoint_rejects_mismatch(tmp_path):
    s = make_test_scene(viewport=(64, 64), max_depth=1)
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, _renderer(s))
    s2 = make_test_scene(viewport=(128, 128), max_depth=1)
    cam2 = racc.Camera.look_at(s2.cam_origin, s2.cam_dir, s2.cam_up,
                               s2.cam_fov, 128, 128)
    with pytest.raises(ValueError, match="viewport"):
        load_checkpoint(ckpt + ".npz", _renderer(s2, cam2))


def test_stats_sliding_window():
    st = RenderStats()
    for i in range(40):
        st.record(1_000_000, 0.01, i + 1)
    assert st.frames == 40
    assert abs(st.sliding_mrays_per_s - 100.0) < 1e-6
    assert abs(st.last.mrays_per_s - 100.0) < 1e-6
    line = st.format_line()
    assert "instant" in line and "sliding" in line
    s = st.summary()
    assert s["rays_traced_total"] == 40_000_000


def test_tonemap_divides_by_spp():
    hdr = np.full((2, 2, 3), 2.0, np.float32)
    out = tonemap(hdr, spp=4)
    assert out.dtype == np.uint8
    assert np.all(out == int(2.0 * 255 / 4))


def test_rmse_helper():
    a = np.zeros((4, 4, 3))
    b = np.ones((4, 4, 3)) * 2
    assert abs(rmse(a, b) - 2.0) < 1e-9


def test_cli_backend_flag_mapping():
    p = cli.build_parser()
    assert cli.select_backend(p.parse_args([])) == "pallas"
    assert cli.select_backend(p.parse_args(["--no-gpu"])) == "xla"
    assert cli.select_backend(p.parse_args(["--no-cpu-tracing"])) == "mxu"
    assert cli.select_backend(p.parse_args(["--backend", "xla",
                                            "--no-cpu-tracing"])) == "xla"


def test_checkpoint_rejects_camera_move(tmp_path):
    """Same viewport, another viewpoint: the fingerprint refuses to blend
    accumulation."""
    s = make_test_scene(viewport=(64, 64), max_depth=1)
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, _renderer(s))
    cam2 = racc.Camera.look_at(np.asarray(s.cam_origin) + 1.0, s.cam_dir,
                               s.cam_up, s.cam_fov, 64, 64)
    with pytest.raises(ValueError, match="fingerprint"):
        load_checkpoint(ckpt + ".npz", _renderer(s, cam2))


def test_cli_resume_uses_stored_key(tmp_path, scene_file):
    """Resuming with another --seed continues the checkpointed key stream:
    two more spp after the resume equal two more spp without one, bit for
    bit."""
    common = ["--scene", scene_file, "--quiet", "--wave-size", "4096",
              "--max-depth", "1", "--backend", "mxu"]
    a, b = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    assert cli_main(common + ["--spp", "3", "--seed", "5", "--out", a]) == 0
    ck = str(tmp_path / "ck")
    assert cli_main(common + ["--spp", "1", "--seed", "5", "--out",
                              str(tmp_path / "x.pfm"), "--checkpoint",
                              ck]) == 0
    assert cli_main(common + ["--spp", "3", "--seed", "999", "--out", b,
                              "--checkpoint", ck]) == 0
    np.testing.assert_array_equal(np.fromfile(a, np.float32),
                                  np.fromfile(b, np.float32))


def test_cli_preview_every_presents_progressively(tmp_path, scene_file):
    """--preview-every writes the output during accumulation: the preview
    written at 1 spp differs from the final 3-spp image."""
    out = str(tmp_path / "p.pfm")
    common = ["--scene", scene_file, "--quiet", "--wave-size", "4096",
              "--max-depth", "1", "--backend", "mxu", "--out", out]
    assert cli_main(common + ["--spp", "1"]) == 0
    one_spp = np.fromfile(out, np.float32)
    os.remove(out)
    assert cli_main(common + ["--spp", "3", "--preview-every", "1"]) == 0
    final = np.fromfile(out, np.float32)
    assert final.shape == one_spp.shape
    assert not np.array_equal(final, one_spp)


@pytest.mark.parametrize("move", [["--orbit", "15"], ["--fly", "0.5"]],
                         ids=["orbit", "fly"])
def test_cli_orbit_animation(tmp_path, move):
    """Scripted camera path: N frames, accumulation reset per move."""
    out = str(tmp_path / "a.png")
    rc = cli_main(["--synthetic", "test", "--spp", "1", "--quiet",
                   "--max-depth", "1", *SMALL, "--anim-frames", "3", *move,
                   "--out", out])
    assert rc == 0
    frames = [tmp_path / f"a_{i:04d}.png" for i in range(3)]
    assert all(f.exists() for f in frames)
    data = [f.read_bytes() for f in frames]
    assert data[0] != data[1] and data[1] != data[2], \
        "a moving camera must change the image"


def test_set_camera_resets_and_reuses_compiled_frame():
    """set_camera resets accumulation, and the next frame equals a fresh
    renderer's at the new camera, bit for bit."""
    s = make_test_scene(viewport=(64, 64), max_depth=1)
    cam0 = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up,
                               s.cam_fov, 64, 64)
    cam1 = cam0.rotate(0.3, s.cam_up, pivot=np.asarray(s.cam_dir))
    r = _renderer(s, cam0)
    r.render_frame(rng.PRNGKey(0))
    r.set_camera(cam1)
    assert r.spp == 0
    assert not r.frame_buffer.any()
    r.render_frame(rng.PRNGKey(5))

    fresh = _renderer(s, cam1)
    fresh.render_frame(rng.PRNGKey(5))
    torch.testing.assert_close(r.frame_buffer, fresh.frame_buffer, rtol=0,
                               atol=0)


# ---- the two packages together ----

GATE_ARGS = ["--synthetic", "test", "--max-depth", "2", *SMALL, "--quiet"]


@pytest.mark.parametrize("backend", [[], ["--backend", "mxu"]],
                         ids=["default", "mxu"])
def test_cli_image_matches_jax_cli(tmp_path, backend):
    """The same arguments through both CLIs: the HDR images pass the
    two-class gate (rmse_trimmed < 1e-3, frac_flip < 0.5%)."""
    args = GATE_ARGS + ["--spp", "2", *backend]
    ours, theirs = str(tmp_path / "port.pfm"), str(tmp_path / "jax.pfm")
    assert cli_main(args + ["--out", ours]) == 0
    assert jax_cli.main(args + ["--out", theirs]) == 0
    img, ref = read_pfm(ours), read_pfm(theirs)
    assert img.shape == ref.shape == (64, 64, 3)
    assert np.isfinite(img).all() and img.max() > 0
    gate = two_class_gate(img.reshape(-1, 3), ref.reshape(-1, 3))
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate


def test_checkpoint_jax_to_port(tmp_path):
    """The JAX CLI checkpoints at 1 spp; the port's CLI resumes it to 3
    spp, and the result passes the gate against the JAX CLI's own 3-spp
    render."""
    args = GATE_ARGS + ["--backend", "mxu", "--seed", "4"]
    ck = str(tmp_path / "ck")
    assert jax_cli.main(args + ["--spp", "1", "--checkpoint", ck, "--out",
                                str(tmp_path / "j1.pfm")]) == 0
    ours, theirs = str(tmp_path / "port3.pfm"), str(tmp_path / "jax3.pfm")
    assert cli_main(args + ["--spp", "3", "--seed", "999", "--checkpoint",
                            ck, "--out", ours]) == 0
    assert jax_cli.main(args + ["--spp", "3", "--out", theirs]) == 0
    gate = two_class_gate(read_pfm(ours).reshape(-1, 3),
                          read_pfm(theirs).reshape(-1, 3))
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate


def test_checkpoint_port_to_jax(tmp_path):
    """The port's CLI checkpoints; the JAX package loads it with spp, the
    framebuffer and the key bitwise equal."""
    args = cli.build_parser().parse_args(
        GATE_ARGS + ["--backend", "mxu", "--spp", "2", "--seed", "3",
                     "--checkpoint", str(tmp_path / "ck"), "--out",
                     str(tmp_path / "p.pfm"), "--device", "cpu"])
    renderer, _ = cli.run(args)

    import rayaccel_tpu as jracc
    s = jax_test_scene(viewport=(64, 64), max_depth=2)
    cam = JaxCamera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                            64, 64)
    jr = jracc.PathTracingRenderer(jracc.create_context(jracc.Configuration(
        backend="mxu", wave_size=4096)), cam, s)
    key = jax_ckpt.load_checkpoint(str(tmp_path / "ck"), jr)
    assert jr.spp == renderer.spp == 2
    np.testing.assert_array_equal(np.asarray(key),
                                  np.asarray(jax.random.PRNGKey(3)))
    np.testing.assert_array_equal(np.asarray(jr.frame_buffer),
                                  renderer.frame_buffer.numpy())


def test_scene_fingerprint_matches_jax():
    """The same scene and camera give the same digest in both packages;
    a moved camera changes it in both."""
    s = make_test_scene(viewport=(64, 64))
    js = jax_test_scene(viewport=(64, 64))
    cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                              64, 64)
    jcam = JaxCamera.look_at(js.cam_origin, js.cam_dir, js.cam_up,
                             js.cam_fov, 64, 64)
    digests = set()
    for angle in (0.0, 0.4):
        ours = scene_fingerprint(types.SimpleNamespace(
            scene_data=s, camera=cam.rotate(angle, s.cam_up)))
        theirs = jax_ckpt.scene_fingerprint(types.SimpleNamespace(
            scene_data=js, camera=jcam.rotate(angle, js.cam_up)))
        assert ours == theirs
        digests.add(ours)
    assert len(digests) == 2


FLAG_CASES = list(itertools.product(
    [False, True], [False, True], [None, "pallas", "mxu", "xla", "sparse"]))


@pytest.mark.parametrize("no_gpu,no_cpu,backend", FLAG_CASES)
def test_select_backend_matches_jax(no_gpu, no_cpu, backend):
    argv = ((["--no-gpu"] if no_gpu else [])
            + (["--no-cpu-tracing"] if no_cpu else [])
            + (["--backend", backend] if backend else []))
    assert (cli.select_backend(cli.build_parser().parse_args(argv))
            == jax_cli.select_backend(jax_cli.build_parser().parse_args(argv)))


def test_parser_accepts_every_jax_option():
    ours = set(cli.build_parser()._option_string_actions)
    theirs = set(jax_cli.build_parser()._option_string_actions)
    assert ours - theirs == {"--device"}
    assert theirs <= ours


def test_cli_never_falls_back_to_the_cpu(tmp_path, monkeypatch):
    """With no --device and no CUDA device the CLI raises, naming the
    missing device, and writes no image."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "none.png"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--synthetic", "test", "--spp", "1", "--quiet", *SMALL,
                  "--out", str(out)])
    assert not out.exists()
