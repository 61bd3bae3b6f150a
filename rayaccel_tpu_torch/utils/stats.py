"""Render statistics and observability.

Counterpart of ``rayaccel_tpu/utils/stats.py``: the per-frame ray counter
returned by racc::render (reference RayAccelerator.cpp:755-758) and the
instant and 32-frame sliding Mrays/s printout of the demo app (reference
main.cpp:35-38, 208-231), with per-frame structured stats. The frame timer
ends on ``torch.cuda.synchronize`` when the renderer runs on a CUDA
device, so that a frame's time is the card's and not the launch queue's.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Optional, Tuple

import torch


@dataclasses.dataclass
class FrameStats:
    rays_traced: int
    seconds: float
    spp: int

    @property
    def mrays_per_s(self) -> float:
        return self.rays_traced / max(self.seconds, 1e-12) / 1e6


class RenderStats:
    """Instant + sliding-window Mrays/s, mirroring the moving average of
    main.cpp:220-231 (window = 32 frames)."""

    WINDOW = 32

    def __init__(self):
        self._window: Deque[Tuple[int, float]] = collections.deque(
            maxlen=self.WINDOW)
        self.frames = 0
        self.total_rays = 0
        self.total_seconds = 0.0
        self.last: Optional[FrameStats] = None
        # Per-stage breakdown, filled by utils.profiling.profile_stages.
        self.stages: Optional[dict] = None

    def record(self, rays_traced: int, seconds: float, spp: int) -> FrameStats:
        self.frames += 1
        self.total_rays += rays_traced
        self.total_seconds += seconds
        self._window.append((rays_traced, seconds))
        self.last = FrameStats(rays_traced, seconds, spp)
        return self.last

    @property
    def sliding_mrays_per_s(self) -> float:
        rays = sum(r for r, _ in self._window)
        secs = sum(s for _, s in self._window)
        return rays / max(secs, 1e-12) / 1e6

    def summary(self) -> dict:
        """Structured per-frame stats."""
        last = self.last
        out = {
            "frames": self.frames,
            "rays_traced_total": self.total_rays,
            "mrays_per_s_instant": last.mrays_per_s if last else 0.0,
            "mrays_per_s_sliding": self.sliding_mrays_per_s,
            "frame_ms": (last.seconds * 1e3) if last else 0.0,
            "spp": last.spp if last else 0,
        }
        if self.stages is not None:
            out["stages"] = self.stages
        return out

    def format_line(self) -> str:
        """The reference's per-frame printout shape (main.cpp:231)."""
        last = self.last
        inst = last.mrays_per_s if last else 0.0
        return f"{inst:5.1f} mrps (instant) {self.sliding_mrays_per_s:5.1f} mrps (sliding)"


class FrameTimer:
    """Context manager timing one frame; the device is drained inside the
    timed window."""

    def __init__(self, stats: RenderStats, renderer):
        self.stats = stats
        self.renderer = renderer

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def run(self, key):
        frame = self.renderer.render_frame(key)
        device = self.renderer.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.rays = int(frame.rays_traced)
        return frame

    def __exit__(self, *exc):
        if exc[0] is None:
            self.stats.record(self.rays, time.perf_counter() - self._t0,
                              self.renderer.spp)
        return False
