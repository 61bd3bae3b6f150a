"""The percentile, rate and idle-share arithmetic, and the reading of a
traced window, on made-up timelines."""

from __future__ import annotations

import pytest

from rtbench import run, stats, timeline


def test_percentile_and_rate():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile(list(range(11)), 90) == pytest.approx(9.0)
    assert stats.percentile([10.0, 20.0], 90) == pytest.approx(19.0)
    assert stats.rate(50, 2.0) == 25
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_union_gaps_and_idle_share():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.union_length(iv, 0, 10) == 5
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    idle = run.load_reader("device.idle_share")
    r = run.Run()
    r.device_busy_s, r.device_window_s = stats.union_length(iv, 0, 10), 10
    assert idle(r) == pytest.approx(50.0)


def _window(frame_ms, rays_per_frame=1_000_000):
    r = run.Run()
    r.frame_ms = frame_ms
    r.window_s = sum(frame_ms) / 1e3
    r.rays = rays_per_frame * len(frame_ms)
    return r


def test_a_stall_in_the_window_moves_the_tail_and_the_rate():
    p90, mrays = run.load_reader("frame_ms_p90.traced"), run.load_reader(
        "mrays_per_s")
    steady = _window([100.0] * 100)
    stalled = _window([100.0] * 85 + [400.0] * 15)
    assert p90(steady) == pytest.approx(100.0)
    assert mrays(steady) == pytest.approx(10.0)
    assert p90(stalled) == pytest.approx(400.0)
    assert mrays(stalled) == pytest.approx(100 / (85 * 0.1 + 15 * 0.4))


def test_the_device_rate_is_the_rays_over_the_devices_busy_time():
    """A stall of the host leaves the device's rate where it was: only
    the device's own time is in it."""
    dev = run.load_reader("mrays_per_device_s")
    host = run.load_reader("mrays_per_s.traced")
    r = _window([100.0] * 85 + [400.0] * 15)
    assert dev(r) is None
    r.device_rays, r.device_busy_s = 8_000_000, 0.4
    assert dev(r) == pytest.approx(20.0)
    assert host(r) == pytest.approx(100 / (85 * 0.1 + 15 * 0.4))
    r.device_busy_s = 0.0
    assert dev(r) is None


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """Two frames of 100 us; the first holds a dense span that launches
    kernel 1 (20 us) with an environment lookup inside it (kernel 2, 5 us)
    and a stream synchronize, then a kernel of the residual layer (3) and
    the harness's synchronize; the second frame one sparse kernel (4)."""
    A = "user_annotation"
    return [
        ev(A, timeline.FRAME, 0, 100), ev(A, timeline.FRAME, 100, 100),
        ev(A, "rtbench.layer.dense", 10, 40),
        ev(A, "rtbench.layer.shade", 20, 10),
        ev(A, "rtbench.layer.sparse", 110, 20),
        ev(A, timeline.HARNESS, 90, 10), ev(A, timeline.HARNESS, 190, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 22, 1, corr=2),
        ev("cuda_runtime", "cudaStreamSynchronize", 40, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=3),
        ev("cuda_runtime", "cudaDeviceSynchronize", 91, 8),
        ev("cuda_runtime", "cudaLaunchKernel", 112, 1, corr=4),
        ev("cuda_runtime", "cudaDeviceSynchronize", 191, 8),
        ev("cpu_op", "aten::sort", 130, 50),
        ev("kernel", "k_dense", 15, 20, corr=1, tid=7),
        ev("kernel", "k_env", 35, 5, corr=2, tid=7),
        ev("kernel", "k_rest", 62, 10, corr=3, tid=7),
        ev("kernel", "k_sparse", 115, 10, corr=4, tid=7),
    ]


def test_a_traced_window_is_read_by_layer_and_frame():
    t = timeline.Timeline(_trace(), residual="shade")
    assert t.n_frames == 2 and t.window_s == pytest.approx(200e-6)
    assert t.layer_ms("dense") == pytest.approx(0.020 / 2)
    assert t.layer_ms("shade") == pytest.approx(0.015 / 2)
    assert t.layer_ms("sparse", frame=1) == pytest.approx(0.010)
    assert t.layer_ms("sparse", frame=0) == 0
    assert t.launches_per_frame() == 2
    assert t.syncs_per_frame() == 0.5          # the harness's left out
    assert t.busy_s == pytest.approx(45e-6)
    assert stats.union_length(t.device_intervals, t.lo, t.hi) == 45
    b = t.breakdown()
    assert b["device_ops"][0] == ["k_dense", pytest.approx(20e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::sort"] == pytest.approx(75e-6)
    # The gap from 72 to 115 us holds the harness's synchronize at its
    # middle.
    assert gaps[timeline.HARNESS] == pytest.approx(43e-6)


class _ProfilerEvent:
    """A Chrome trace event as the profiler's own event object."""

    def __init__(self, e):
        self.e = e

    def device_type(self):
        from torch.autograd import DeviceType
        return (DeviceType.CUDA if self.e["cat"] in timeline.DEVICE_CATS
                else DeviceType.CPU)

    def name(self):
        return self.e["name"]

    def start_ns(self):
        return self.e["ts"] * 1000

    def duration_ns(self):
        return self.e["dur"] * 1000


def test_the_device_window_runs_between_device_synchronizes():
    events = [_ProfilerEvent(e) for e in _trace()]
    busy, window = timeline.sync_window(events)
    assert window == pytest.approx((199 - 99) * 1e-6)
    assert busy == pytest.approx(10e-6)
    with pytest.raises(ValueError):
        timeline.sync_window([e for e in events
                              if e.name() != "cudaDeviceSynchronize"])


def test_innermost_span():
    spans = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 70, "d")]
    got = timeline.innermost(spans, [5, 25, 40, 65, 80, 120])
    assert [g[2] if g else None for g in got] == ["a", "c", "b", "d", "a",
                                                  None]
