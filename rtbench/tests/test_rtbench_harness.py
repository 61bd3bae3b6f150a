"""The harness finds everything by name, refuses what it cannot find,
and takes a cell, a traffic mix or a metric added as files alone."""

from __future__ import annotations

import io
import json
import os
import re
import shutil
from contextlib import redirect_stderr, redirect_stdout

import pytest

from rtbench import run, scene
from rtbench.tests.conftest import CELLS, tiny_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_file_is_found_by_name():
    bench = run.load_bench()
    for cell in bench["workloads"]:
        assert os.path.exists(os.path.join(run.HERE, "configs",
                                           cell["config"] + ".json"))
        assert os.path.exists(os.path.join(run.HERE, "traffic",
                                           cell["traffic"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    layers = run.load_layers()
    assert {"renderer", "dense", "sparse", "shade"} <= set(layers)
    names = {s["layer"] for s in layers.values()} | {"device"}
    assert {m["layer"] for m in bench["per_layer"]} <= names


def test_benchmark_json_keeps_the_contracts_shape():
    bench = run.load_bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 2 + 14 * 24 <= 43200 and (
        (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200
        <= 43200)
    metrics = bench["end_to_end"] + bench["per_layer"]
    for item in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for cell in bench["workloads"]:
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        assert any(cell["name"] in m.get("workloads", [cell["name"]])
                   for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        run.find_cell(run.load_bench(), "no.such.cell")
    err = io.StringIO()
    with redirect_stderr(err):
        assert run.main(["--workload", "no.such.cell", "--seed", "1",
                         "--seconds", "1"]) == 2
    assert "unknown workload" in err.getvalue()


def test_no_card_no_result():
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "pt.d2", "--seed", "1",
                       "--seconds", "1"])
    assert rc == 3 and out.getvalue() == ""


def test_a_cell_added_as_files_runs_without_an_edit(tmp_path):
    here = tmp_path / "rtbench"
    shutil.copytree(run.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = run.load_bench()
    traffic = json.loads((here / "traffic" / "pt.d2.json").read_text())
    traffic.update(max_depth=1, why="paths of one bounce")
    (here / "traffic" / "pt.d1.json").write_text(json.dumps(traffic))
    (here / "metrics" / "frames_per_s.py").write_text(
        "def read(run):\n    return len(run.frame_ms) / run.window_s\n")
    (here / "metrics" / "dense.calls_per_frame.py").write_text(
        "def read(run):\n    return None\n")
    (here / "metrics" / "render.frames_traced.py").write_text(
        "def read(run):\n    return run.timeline.n_frames\n")
    bench["workloads"].append({"name": "pt.d1", "config": "battlefield_pt",
                               "traffic": "pt.d1", "chips": 1,
                               "why": "one bounce"})
    bench["end_to_end"].append({"name": "frames_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock"})
    for name in ("dense.calls_per_frame", "render.frames_traced"):
        bench["per_layer"].append({"name": name, "unit": "count",
                                   "better": "lower",
                                   "source": "program_counter",
                                   "layer": "dense engine",
                                   "moves": "mrays_per_device_s"})
    result, numbers = tiny_run("pt.d1", bench=bench, here=str(here))
    assert result["correct"], numbers
    # mrays_per_s is due in the cells that BENCHMARK.json lists for it,
    # and mrays_per_device_s, read from the device's trace, not on the CPU.
    assert set(result["metrics"]) == {"setup_s", "frames_per_s"}
    traced, _ = tiny_run("pt.d1", bench=bench, here=str(here), trace=True)
    # A reader that finds nothing to read leaves its metric out; as the
    # metric is due in every cell, the run is not correct.
    assert "dense.calls_per_frame" not in traced["metrics"]
    assert set(traced["metrics"]) == {"render.frames_traced"}
    assert traced["check"]["metrics_unread"]["value"] == 1
    assert not traced["correct"]


def test_a_layer_out_of_sight_is_not_correct(tmp_path):
    """An engine that the frame reaches by another name than its layer
    file gives leaves the layer's metrics unread: not correct."""
    here = tmp_path / "rtbench"
    shutil.copytree(run.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    dense = json.loads((here / "layers" / "dense.json").read_text())
    dense["entries"] = [e for e in dense["entries"]
                        if e["kind"] == "occlusion"]
    (here / "layers" / "dense.json").write_text(json.dumps(dense))
    traced, numbers = tiny_run("pt.d2", here=str(here), trace=True)
    assert numbers["layers_unseen"]["value"] == 1
    assert not traced["correct"]
    sound, numbers = tiny_run("pt.d2", trace=True)
    assert numbers["layers_unseen"]["value"] == 0
    assert numbers["metrics_unread"]["value"] == 0 and sound["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_has_the_contracts_keys(cell):
    result, numbers = tiny_run(cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "check"
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    traced, _ = tiny_run(cell, trace=True)
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


# A scene of a few boxes on a ground slab, made up for the test: what a
# configuration that brings its own scene puts under rtbench/scenes/.
BOXES = '''
import numpy as np

from rtbench import scene


def generate(layout_seed, *, max_depth, n_boxes=6, viewport=(64, 48)):
    rng = np.random.default_rng(layout_seed)
    parts = [scene._box((0.0, -0.5, 0.0), (120.0, 1.0, 120.0))]
    for p, s in zip(rng.uniform(-20, 20, (n_boxes, 2)),
                    rng.uniform(1, 6, (n_boxes, 3))):
        parts.append(scene._box((p[0], s[1] * 0.5, p[1]), s))
    vertices = np.concatenate([v for v, _ in parts])
    indices = np.concatenate([t + 8 * i for i, (_, t) in enumerate(parts)])
    origin, target, up, fov = scene.CAMERA
    return dict(
        vertices=vertices, indices=indices,
        triangle_materials=rng.integers(0, 4, len(indices)).astype(np.uint16),
        triangle_normals=scene._face_normals(vertices, indices),
        normals=scene._vertex_normals(vertices, indices),
        texcoords=np.zeros((len(vertices), 2), np.float32),
        materials=scene.MATERIALS.copy(), max_depth=int(max_depth),
        viewport_width=int(viewport[0]), viewport_height=int(viewport[1]),
        cam_origin=np.asarray(origin, np.float32),
        cam_dir=np.asarray(target, np.float32),
        cam_up=np.asarray(up, np.float32), cam_fov=float(fov),
        env_pixels=scene.gradient_environment())
'''


def test_a_scene_added_as_a_file_runs_without_an_edit(tmp_path):
    here = tmp_path / "rtbench"
    shutil.copytree(run.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (here / "scenes" / "boxes.py").write_text(BOXES)
    sc = {"generator": "boxes", "layout_seed": 11,
          "args": {"n_boxes": 6, "viewport": [64, 48]}}
    config = json.loads((here / "configs" / "battlefield_pt.json").read_text())
    config.update(name="boxes_pt", scene=sc)
    (here / "configs" / "boxes_pt.json").write_text(json.dumps(config))
    bench = run.load_bench()
    bench["configs"].append({"name": "boxes_pt", "source": "a test",
                             "file": "rtbench/configs/boxes_pt.json",
                             "reduced": [], "why": "a scene as a file"})
    bench["workloads"].append({"name": "boxes.pt.d2", "config": "boxes_pt",
                               "traffic": "pt.d2", "chips": 1,
                               "why": "a scene as a file"})
    # The scene's own args in place of the small battlefield's.
    result, numbers = tiny_run("boxes.pt.d2", bench=bench, here=str(here),
                               overrides={"config": {"scene": sc}})
    assert result["correct"], numbers
    assert numbers["differ_pct"]["value"] == 0


def test_an_unknown_scene_generator_is_refused(tmp_path):
    assert scene.find("battlefield_like", run.HERE) is scene.battlefield_like
    (tmp_path / "scenes").mkdir()
    (tmp_path / "scenes" / "boxes.py").write_text(BOXES)
    assert callable(scene.find("boxes", str(tmp_path)))
    with pytest.raises(KeyError) as e:
        scene.find("no_such_scene", str(tmp_path))
    assert "battlefield_like" in str(e.value) and "boxes" in str(e.value)
