"""Helpers of the benchmark's own tests, which run on the CPU at a small
size (``python -m pytest rtbench/tests``); the one test marked ``cuda``
runs a cell on the card and skips without one."""

from __future__ import annotations

import time

import pytest
import torch

from rtbench import run

# A small scene and frame: 20 boxes on a 21 x 21 terrain, 64 x 48 pixels
# in waves of 1024 lanes; every pixel and every frame of the window
# compared, so that a sound run agrees exactly.
TINY = {"config": {"scene": {"args": {"n_objects": 20, "grid": 21,
                                      "viewport": [64, 48]}},
                   "configuration": {"wave_size": 1024, "trace_block": 512}},
        "traffic": {"check_pixels": 1 << 20, "check_frames": 1 << 20,
                    "max_frames": 6, "trace_frames": 2}}
CELLS = ["pt.d2", "whitted.shadow", "whitted.d8", "pt.d8", "pt.d2.stratified"]


def tiny_run(cell, seed=20261017, trace=False, overrides=None, fault=None,
             bench=None, here=run.HERE):
    """``run_cell`` of ``cell`` on the CPU at the small size; returns
    (result, numbers)."""
    bench = bench or run.load_bench()
    ov = run.merged(TINY, None)
    for k, v in (overrides or {}).items():
        ov[k] = run.merged(ov[k], v)
    result, numbers = run.run_cell(
        bench, run.find_cell(bench, cell), seed, 0.2, trace,
        torch.device("cpu"), time.perf_counter(), ov, here=here,
        log=lambda obj: None, after_setup=fault)
    return result, numbers


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
