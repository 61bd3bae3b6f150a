"""The port's benchmark (``rayaccel_tpu_torch/bench.py``) against the
repo-root ``bench.py``, on the CPU at 64x64.

``bench.py`` is read as text and never imported: importing it points JAX's
compilation cache elsewhere for the whole worker. The port's matrix runs
through ``main(scene_data=..., device="cpu", environ=...)`` on the test
scene, one frame a config, the oracle at 2,048 rays a set and the dry run
on two gloo ranks:

- metric names are ``bench.py``'s, with the three TPU names renamed and
  the device probe gone;
- one knobs line, then one line a metric, the headline first and last,
  ``rays > 0`` and ``dropped == 0`` on every config line, exit code 0;
- a config that raises prints its error line, the headline is still
  last, and ``main`` returns non-zero; so does a failing oracle gate, and
  a failed headline ends on a headline-shaped error line;
- ``BENCH_DEADLINE_S=0`` skips every config but the headline;
- with no CUDA device the run raises before it prints anything.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from rayaccel_tpu_torch import bench
from rayaccel_tpu_torch.scene.loader import make_test_scene
from rayaccel_tpu_torch.tools import oracle_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(BENCH_FRAMES="1", BENCH_WAVE="4096", BENCH_TILE="512",
             BENCH_CS="32", BENCH_RMSE_SPP="1")
RENAMED = {"multichip_mesh1_tpu_mrays_per_s":
           "multichip_mesh1_gpu_mrays_per_s",
           "oracle_tpu": "oracle_gpu", "oracle_tpu_rows": "oracle_gpu_rows"}
CONFIG_METRICS = ["pt_battlefield_mrays_per_s_per_chip",
                  "multichip_mesh1_gpu_mrays_per_s",
                  "whitted_primary_shadow_mrays_per_s",
                  "whitted_depth8_mrays_per_s", "pt8_fullbsdf_mrays_per_s",
                  "pt_stratified_mrays_per_s", "multichip_cpu_mesh_smoke",
                  "oracle_gpu"]


def run(monkeypatch, **env):
    """(exit code, parsed lines) of the port's matrix on the test scene."""
    monkeypatch.setattr(bench, "ORACLE_RAYS", 2048)
    monkeypatch.setattr(bench, "DRYRUN_RANKS", 2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(scene_data=make_test_scene(viewport=(64, 64)),
                        device="cpu", environ={**SMALL, **env})
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()]


@pytest.fixture(scope="module")
def matrix():
    with pytest.MonkeyPatch.context() as mp:
        return run(mp)


def test_metric_names_are_bench_pys(matrix, monkeypatch):
    with open(os.path.join(ROOT, "bench.py")) as f:
        text = f.read()
    ref = set(re.findall(r'"metric":\s*"(\w+)"', text))
    ref |= set(re.findall(r'(?:guarded|line)\(\s*"(\w+)"', text))
    ref.discard("device_probe")
    monkeypatch.setattr(oracle_lib, "run_oracle",
                        lambda *a, **k: ([dict(hit_agree=0.5,
                                               t_within_1e3=1.0,
                                               overflow=0)], False))
    _, failing = run(monkeypatch, BENCH_ONLY="7")
    port = {ln["metric"] for ln in matrix[1] + failing}
    assert port == {RENAMED.get(m, m) for m in ref}
    assert "bench_knobs" in port and "oracle_gpu_rows" in port


def test_matrix_lines(matrix):
    rc, lines = matrix
    assert rc == 0
    assert [ln["metric"] for ln in lines] == (
        ["bench_knobs"] + CONFIG_METRICS + [CONFIG_METRICS[0]])
    knobs = lines[0]
    assert knobs["device"] == "cpu" and knobs["nvidia_smi"] is None
    assert knobs["knobs"]["cluster_size"] == 32
    assert knobs["knobs"]["k_pairs"] == 4
    assert knobs["knobs"]["min_stage_width"] == 8192
    assert lines[-1] == lines[1]
    for ln in lines[1:]:
        assert ln["dropped"] == 0 and ln["unit"] in ("Mrays/s", "ok"), ln
        if ln["unit"] == "Mrays/s":
            assert ln["rays"] > 0 and ln["frame_ms"] > 0
        else:
            assert ln["value"] == 1
    assert "vs_baseline" not in lines[1]
    by = {ln["metric"]: ln for ln in lines}
    assert by["multichip_cpu_mesh_smoke"]["ranks"] == 2
    assert by["oracle_gpu"]["rows"] == 10


def test_a_config_that_raises_fails_the_run(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("broken renderer")

    monkeypatch.setattr(bench.racc, "WhittedRenderer", broken)
    rc, lines = run(monkeypatch, BENCH_ONLY="2,1")
    assert rc != 0
    assert [ln["metric"] for ln in lines] == [
        "bench_knobs", CONFIG_METRICS[0],
        "whitted_primary_shadow_mrays_per_s", CONFIG_METRICS[0]]
    assert lines[2]["unit"] == "error" and "broken renderer" in \
        lines[2]["error"]
    assert lines[-1] == lines[1] and lines[-1]["unit"] == "Mrays/s"


def test_a_failed_headline_ends_on_its_error_line(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("broken renderer")

    monkeypatch.setattr(bench.racc, "PathTracingRenderer", broken)
    rc, lines = run(monkeypatch, BENCH_ONLY="2")
    assert rc != 0
    assert [ln["metric"] for ln in lines] == ["bench_knobs"] + \
        [CONFIG_METRICS[0]] * 2
    assert lines[1]["unit"] == lines[2]["unit"] == "error"


def test_a_failing_oracle_fails_the_run(monkeypatch):
    monkeypatch.setattr(oracle_lib, "run_oracle",
                        lambda *a, **k: ([dict(hit_agree=0.5,
                                               t_within_1e3=1.0,
                                               overflow=0)], False))
    rc, lines = run(monkeypatch, BENCH_ONLY="7")
    assert rc != 0
    assert [ln["metric"] for ln in lines] == ["bench_knobs",
                                              "oracle_gpu_rows",
                                              "oracle_gpu"]
    assert lines[-1]["value"] == 0 and lines[-1]["min_hit_agree"] == 0.5


def test_deadline_skips_all_but_the_headline(monkeypatch):
    rc, lines = run(monkeypatch, BENCH_DEADLINE_S="0")
    assert rc == 0
    assert [ln["metric"] for ln in lines] == (
        ["bench_knobs"] + CONFIG_METRICS + [CONFIG_METRICS[0]])
    assert lines[1]["unit"] == "Mrays/s" and lines[-1] == lines[1]
    assert all(ln["unit"] == "skipped_deadline" for ln in lines[2:-1])


def test_no_cuda_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(scene_data=make_test_scene(viewport=(64, 64)),
                   environ=SMALL)
    assert out.getvalue() == ""


def test_command_without_a_card_exits_nonzero():
    proc = subprocess.run(
        [sys.executable, "-m", "rayaccel_tpu_torch.bench"], cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
