"""Tiled progressive renderer base.

Counterpart of ``rayaccel_tpu/render/tiled.py``: ``block_swizzle``
(``:46-71``) and ``TiledRenderer``, which keeps the HDR accumulation buffer
in block-swizzled lane order, one contiguous slice per wave, and
un-permutes it in :meth:`TiledRenderer.image`. The default frame body
(``:220-249``) is a loop over waves around the subclass's
:meth:`TiledRenderer._trace_wave`, each wave keyed ``fold_in(key, w)``; a
subclass with a frame-pooled body overrides :meth:`TiledRenderer._render`.
Each frame ends in the :meth:`TiledRenderer.end_frame` hook (``:292``).
:func:`bind_scene` and :meth:`TiledRenderer._setup` are the renderers'
shared set-up: the engine family, the scene, the environment, the bounce
engine and the engine knobs.

With a mesh of D ranks (``context.mesh``), each rank traces and keeps its
block of every wave, lanes ``[rank*R/D, (rank+1)*R/D)``, as JAX's shard of
``P(None, "tiles")`` does; the default body folds the rank into the key
before the wave (``:229-241``), and ``traced`` and ``dropped`` are summed
over the ranks every frame (``:286-287``). :attr:`frame_buffer`,
:meth:`set_frame_buffer` and :meth:`image` speak of the whole lane-order
buffer (gathered from every rank, so every rank must call them), so a
checkpoint is the JAX package's file.
"""

from __future__ import annotations

import numpy as np
import torch

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.context import Context
from rayaccel_tpu_torch.device import to_device
from rayaccel_tpu_torch.environment import Environment, create_environment
from rayaccel_tpu_torch.parallel.mesh import replicate_scene
from rayaccel_tpu_torch.scene.clusters import ClusterScene, compile_clusters
from rayaccel_tpu_torch.scene.compile import compile_scene
from rayaccel_tpu_torch.scene.data import SceneData
from rayaccel_tpu_torch.types import Stats
from rayaccel_tpu_torch.utils.spans import span

BLOCK_W = 32
BLOCK_H = 16
CLUSTER_BACKENDS = ("mxu", "pallas", "sparse")


def block_swizzle(width: int, height: int, pad_to: int):
    """Flat pixel ids in block-major order, padded with -1 to ``pad_to``.

    Returns (perm, x, y) int64 arrays of length pad_to; padding lanes have
    perm == -1 and x = y = 0.
    """
    bw, bh = BLOCK_W, BLOCK_H
    nbx = -(-width // bw)
    nby = -(-height // bh)
    ys, xs = np.mgrid[0:nby * bh, 0:nbx * bw]
    inside = (xs < width) & (ys < height)
    key = (((ys // bh) * nbx + (xs // bw)).astype(np.int64) * (bw * bh)
           + (ys % bh) * bw + (xs % bw))
    order = np.argsort(key.ravel(), kind="stable")
    xs = xs.ravel()[order]
    ys = ys.ravel()[order]
    inside = inside.ravel()[order]
    n = len(xs)
    assert pad_to >= n
    perm = np.full(pad_to, -1, np.int64)
    x = np.zeros(pad_to, np.int64)
    y = np.zeros(pad_to, np.int64)
    perm[:n] = np.where(inside, ys * width + xs, -1)
    x[:n] = xs
    y[:n] = ys
    return perm, x, y


def bind_scene(backend: str, scene_data: SceneData, tpu_scene, device):
    """The renderers' engine choice: (backend, compiled scene). A scene
    handed in decides the engine family (a ClusterScene moves a non-cluster
    backend to "mxu", a TpuScene a cluster backend to "xla"), whatever its
    device: ``TiledRenderer._bind`` moves it to the renderer's. Otherwise
    the scene is compiled for the backend on ``device``."""
    if backend == "bruteforce":
        raise ValueError(
            "backend 'bruteforce' is the test oracle and runs no renderer: "
            "call ops.trace.trace(scene, rays, backend='bruteforce')")
    if tpu_scene is not None:
        if isinstance(tpu_scene, ClusterScene):
            if backend not in CLUSTER_BACKENDS:
                backend = "mxu"
        elif backend in CLUSTER_BACKENDS:
            backend = "xla"
        return backend, tpu_scene
    if backend in CLUSTER_BACKENDS:
        return backend, compile_clusters(scene_data, device=device)
    return backend, compile_scene(scene_data, device=device)


class TiledRenderer:
    """Owns the lane-order framebuffer and the frame's wave inputs; a
    subclass supplies :meth:`_trace_wave` (one wave of one progressive
    sample) and may override :meth:`_render` (the whole sample)."""

    tile_size = 128  # reference TiledRenderer.h:37 (kept for API parity)

    def __init__(self, context: Context, width: int, height: int):
        self.context = context
        self.device = context.device
        self.width = int(width)
        self.height = int(height)
        cfg = context.configuration
        self.wave_size = min(cfg.wave_size, cfg.max_rays_in_flight)
        self.n_pixels = self.width * self.height

        n_blocks = (-(-self.width // BLOCK_W)) * (-(-self.height // BLOCK_H))
        n_lanes = n_blocks * BLOCK_W * BLOCK_H
        self.n_waves = -(-n_lanes // self.wave_size)
        self.n_lanes = self.n_waves * self.wave_size
        self.mesh = context.mesh
        n_shards = self.mesh.size if self.mesh else 1
        if self.wave_size % n_shards:
            raise ValueError(f"wave_size {self.wave_size} does not split "
                             f"over a mesh of {n_shards} ranks")
        # This rank's lanes of every wave.
        self.shard_lanes = self.wave_size // n_shards
        lo = (self.mesh.rank if self.mesh else 0) * self.shard_lanes
        self._lanes = slice(lo, lo + self.shard_lanes)

        perm, x, y = block_swizzle(self.width, self.height, self.n_lanes)
        self._perm = perm
        shape = (self.n_waves, self.wave_size)

        def local(a, dtype=None):
            return torch.as_tensor(a.reshape(shape)[:, self._lanes],
                                   dtype=dtype, device=self.device)

        self._wave_x = local(x, torch.int32)
        self._wave_y = local(y, torch.int32)
        self._wave_alive = local(perm >= 0)
        self.spp = 0
        self._rays = torch.zeros((), dtype=torch.int64, device=self.device)
        self._dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        self._fb3 = self._make_fb()

    def _setup(self, camera, scene_data: SceneData, tpu_scene,
               environment: Environment | None):
        """The renderers' shared set-up. The configuration's ``backend``
        traces the primaries; under ``hybrid_tracing`` the bounces of the
        dense engines ("pallas", "mxu") go to the sparse pair engine. The
        environment defaults to the scene's probe. ``pooled`` is whether
        the configuration's ``regroup`` takes the pooled frame: only a
        cluster engine runs it."""
        cfg = self.context.configuration
        self.camera = camera
        self.scene_data = scene_data
        self.backend, scene = bind_scene(cfg.backend, scene_data, tpu_scene,
                                         self.device)
        self.bounce_backend = (
            "sparse" if cfg.hybrid_tracing and self.backend in ("mxu",
                                                                "pallas")
            else self.backend)
        if environment is None:
            env_px = scene_data.env_pixels
            assert env_px is not None, "scene has no environment probe"
            environment = create_environment(env_px, env_px.shape[1],
                                             env_px.shape[0],
                                             device=self.device)
        self._bind(scene, environment)
        self.max_depth = int(scene_data.max_depth)
        self.opts = cfg.engine_opts()
        self.tile = min(cfg.trace_block, self.shard_lanes)
        self.stack_depth = cfg.traversal_stack_depth
        self.min_stage_width = cfg.min_stage_width
        self.pooled = cfg.regroup and self.backend in CLUSTER_BACKENDS

    def _make_fb(self) -> torch.Tensor:
        return torch.zeros((self.n_waves, self.shard_lanes, 3),
                           dtype=torch.float32, device=self.device)

    def clear(self):
        """Reset progressive accumulation."""
        self._fb3 = self._make_fb()
        self.spp = 0

    @property
    def frame_buffer(self) -> torch.Tensor:
        """Swizzled lane-order accumulation buffer, (n_lanes, 3): with a
        mesh, every rank's lanes gathered (a collective)."""
        if self.mesh is None:
            return self._fb3.reshape(self.n_lanes, 3)
        return self.mesh.all_gather(self._fb3).transpose(0, 1).reshape(
            self.n_lanes, 3)

    def set_frame_buffer(self, fb_flat):
        """Restore a flat (n_lanes, 3) buffer (checkpoint resume); with a
        mesh, each rank keeps its lanes of it."""
        fb3 = torch.as_tensor(fb_flat, dtype=torch.float32).reshape(
            self.n_waves, self.wave_size, 3)[:, self._lanes]
        self._fb3 = fb3.to(self.device).clone()

    def _bind(self, scene, environment):
        """Bind ``scene`` and ``environment``, the objects
        ``render/api.py:render`` compares a re-published one with. The
        renderer traces copies of them on its device (a scene built on the
        host runs on the renderer's card); under a mesh every rank traces
        rank 0's copies."""
        self._bound_scene, self._bound_env = scene, environment
        scene = to_device(scene, self.device)
        environment = to_device(environment, self.device)
        if self.mesh is not None:
            scene = replicate_scene(self.mesh, scene)
            environment = replicate_scene(self.mesh, environment)
        self.scene, self.environment = scene, environment

    def _mesh_kwargs(self) -> dict:
        """The pooled frames' mesh arguments (none without a mesh)."""
        if self.mesh is None:
            return {}
        return dict(mesh=self.mesh, n_shards=self.mesh.size,
                    reshard=self.context.configuration.reshard_bounces)

    def set_camera(self, camera):
        """Move the camera and reset progressive accumulation."""
        self.camera = camera
        self.clear()

    def _camera_arrays(self):
        """The camera as tensors on the renderer's device: four uploads,
        each a host wait."""
        with span("racc.render.read.camera"):
            return self.camera.as_arrays(self.device)

    @property
    def dropped(self) -> int:
        """Overflow/drop counter (reading syncs)."""
        return int(self._dropped)

    @property
    def rays_traced_total(self) -> int:
        """Lifetime rays-traced counter (reading syncs)."""
        return int(self._rays)

    def image(self) -> np.ndarray:
        """Accumulated HDR image divided by spp, un-permuted to (H, W, 3)."""
        spp = max(self.spp, 1)
        fb = self.frame_buffer.cpu().numpy()
        img = np.zeros((self.n_pixels, 3), np.float32)
        valid = self._perm >= 0
        img[self._perm[valid]] = fb[valid]
        return img.reshape(self.height, self.width, 3) / spp

    def render_frame(self, key) -> Stats:
        """Render one progressive sample over the full viewport with the
        :mod:`rng` key ``key``. With a mesh every rank calls it with the
        same key; ``rays_traced`` is the sum over the ranks. The frame,
        accumulation included, is the span ``racc.render.frame``."""
        with span("racc.render.frame"):
            rad, traced, dropped = self._render(key)
            self._fb3 += rad
            if self.mesh is not None:
                with span("racc.render.exchange"):
                    counts = torch.stack([torch.as_tensor(c, dtype=torch.int64)
                                          .to(self.device)
                                          for c in (traced, dropped)])
                    traced, dropped = self.mesh.all_reduce(counts)
            self._rays += traced
            self._dropped += dropped
            self.spp += 1
            self.end_frame()
        return Stats(rays_traced=traced)

    def end_frame(self):
        """Hook run after each frame, as ``TiledRenderer::endFrame``
        (reference TiledRenderer.cpp:62-64)."""

    def _render(self, key):
        """(radiance (n_waves, shard_lanes, 3), traced, dropped) of this
        rank's lanes of one sample: by default every wave traced to
        completion on its own, with ``wave_key = fold_in(key, w)``, the
        rank folded into ``key`` first under a mesh."""
        if self.mesh is not None:
            key = rng.fold_in(key, self.mesh.rank)
        rads, traced, dropped = [], 0, 0
        for w in range(self.n_waves):
            with span("racc.render.wave"):
                rad, n, d = self._trace_wave(
                    self._wave_x[w], self._wave_y[w], self._wave_alive[w],
                    rng.fold_in(key, w))
            rads.append(rad)
            traced = traced + n
            dropped = dropped + d
        return torch.stack(rads), traced, dropped

    def _trace_wave(self, x, y, alive, wave_key):
        """(radiance (shard_lanes, 3), traced, dropped) of one wave."""
        raise NotImplementedError
