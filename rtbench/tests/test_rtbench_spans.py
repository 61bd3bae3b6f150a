"""The readers of the program's own spans (``rtbench/spans.py``): on a
made-up traced window, and in a traced run of each cell at the small
size."""

from __future__ import annotations

import contextlib
import sys

import pytest

from rtbench import run, timeline
from rtbench.tests.conftest import CELLS, tiny_run
from rtbench.tests.test_rtbench_stats import ev

NEW = ["render.idle_ms_per_frame", "dense.idle_ms_per_frame",
       "sparse.idle_ms_per_frame", "shade.idle_ms_per_frame",
       "render.loop_iterations_per_frame", "sparse.passes_per_call",
       "render.unnamed_syncs_per_frame"]


def _trace(program=True):
    """One frame of 100 us. The program's frame span (0-90) holds two
    loop steps: a dense call (10-40) whose kernel runs 15-35, a sparse
    call of two passes (40-60) inside the second, then a count read back
    (60-70) whose synchronize waits at 62 for the kernel at 65-68, and an
    unnamed synchronize at 75; the harness's synchronize ends the frame
    (90-100). Idle: 0-15, 35-65 and 68-100."""
    A = "user_annotation"
    events = [
        ev(A, timeline.FRAME, 0, 100), ev(A, timeline.HARNESS, 90, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_runtime", "cudaStreamSynchronize", 62, 6),
        ev("cuda_runtime", "cudaLaunchKernel", 61, 1, corr=2),
        ev("cuda_runtime", "cudaStreamSynchronize", 75, 1),
        ev("cuda_runtime", "cudaDeviceSynchronize", 91, 8),
        ev("kernel", "k_dense", 15, 20, corr=1, tid=7),
        ev("kernel", "k_count", 65, 3, corr=2, tid=7),
    ]
    if program:
        events += [
            ev(A, "racc.render.frame", 0, 90),
            ev(A, "racc.render.loop", 5, 35), ev(A, "racc.dense", 10, 30),
            ev(A, "racc.render.loop", 40, 20), ev(A, "racc.sparse", 40, 20),
            ev(A, "racc.sparse.pass", 41, 9),
            ev(A, "racc.sparse.pass", 50, 9),
            ev(A, "racc.render.read.pool_count", 60, 10),
        ]
    return events


def _read(name, events):
    r = run.Run()
    r.timeline = timeline.Timeline(events, residual="shade")
    return run.load_reader(name)(r)


def test_idle_stretches_go_to_the_innermost_program_span():
    events = _trace()
    # 0-5 the frame, 5-10 the first loop step, 10-15 the dense call;
    # 35-65 runs over the end of the dense call (35-40), the sparse
    # call (40-60, its passes 41-59) and the read
    # (60-65); 68-100 over the read (68-70), the frame (70-90) and the
    # harness's synchronize (90-100), which counts nowhere.
    assert _read("render.idle_ms_per_frame", events) == pytest.approx(
        (5 + 5 + 5 + 2 + 20) / 1e3)
    assert _read("dense.idle_ms_per_frame", events) == pytest.approx(10e-3)
    assert _read("sparse.idle_ms_per_frame", events) == pytest.approx(20e-3)
    assert _read("shade.idle_ms_per_frame", events) == 0.0
    total = sum(_read(n, events) for n in NEW[:4])
    assert total == pytest.approx((100 - 23 - 10) / 1e3)


def test_loops_passes_and_unnamed_waits():
    events = _trace()
    assert _read("render.loop_iterations_per_frame", events) == 2
    assert _read("sparse.passes_per_call", events) == 2
    # The wait at 62 lies under the read span, the harness's at 91 under
    # its own span: only the one at 75 is unnamed.
    assert _read("render.syncs_per_frame", events) == 2
    assert _read("render.unnamed_syncs_per_frame", events) == 1


def test_a_program_without_spans_reads_zero_and_every_wait_unnamed():
    # A program older than its spans still runs under these readers, and
    # a due metric that reads nothing fails the run (metrics_unread).
    events = _trace(program=False)
    assert _read("render.syncs_per_frame", events) == 2
    assert [_read(n, events) for n in NEW] == [0.0] * 6 + [2.0]


def test_a_window_without_device_operations_reads_no_idle_time():
    events = [e for e in _trace() if e["cat"] != "kernel"]
    assert [_read(n, events) for n in NEW[:4]] == [None] * 4


@pytest.fixture
def program_without_spans(monkeypatch):
    """The program as it was before it marked its frames: every module's
    ``span`` a null context, profiler or not."""
    from rayaccel_tpu_torch.utils import spans as program_spans
    off = lambda name: contextlib.nullcontext()  # noqa: E731
    on = program_spans.span
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("rayaccel_tpu_torch")
                and getattr(mod, "span", None) is on):
            monkeypatch.setattr(mod, "span", off)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_of_a_program_without_spans_is_correct(
        cell, program_without_spans):
    result, numbers = tiny_run(cell, trace=True)
    assert numbers["metrics_unread"]["value"] == 0
    assert numbers["layers_unseen"]["value"] == 0 and result["correct"]
    assert result["metrics"]["render.loop_iterations_per_frame"][
        "value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_programs_counters(cell):
    result, numbers = tiny_run(cell, trace=True)
    assert numbers["metrics_unread"]["value"] == 0
    assert numbers["layers_unseen"]["value"] == 0 and result["correct"]
    bench = run.load_bench()
    due = {m["name"] for m in run.cell_metrics(
        bench, run.find_cell(bench, cell), "per_layer")}
    assert "render.loop_iterations_per_frame" in due
    loops = result["metrics"]["render.loop_iterations_per_frame"]["value"]
    assert loops >= 1
    if cell == "whitted.shadow":
        # One step a wave: 64 x 48 pixels in waves of 1024 lanes.
        assert loops == 3 and "sparse.passes_per_call" not in due
    else:
        assert result["metrics"]["sparse.passes_per_call"]["value"] >= 1
