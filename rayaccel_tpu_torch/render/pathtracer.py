"""Frame-pooled wavefront path tracer.

Counterpart of ``rayaccel_tpu/render/pathtracer.py``: ``pt_shade``,
``_trace_and_surface`` (the ``"pallas"`` and ``"sparse"`` engines),
``_shade_advance``, the uniform ``_primary_rays``, ``pt_trace_frame``
(``:361-669``) on one device with the fast width shrink, and the
frame-pooled ``PathTracingRenderer``. The random streams follow the JAX
key chains exactly: stage 1 draws positionally from ``fold_in(key, w)``
(camera jitter from ``fold_in(wkey, 0)``, the first BSDF sample from
``fold_in(wkey, 1)``), bounce b draws per lane id from
``fold_in(key, 4096 + b)``.

The JAX function is one compiled program with ``lax.scan`` /
``while_loop`` / ``cond``; here the same control flow runs eagerly, with
the loop conditions read on the host.
"""

from __future__ import annotations

import torch

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.camera import Camera, generate_pixel_rays
from rayaccel_tpu_torch.config import EngineOpts
from rayaccel_tpu_torch.context import Context
from rayaccel_tpu_torch.environment import (Environment, create_environment,
                                            sample_environment)
from rayaccel_tpu_torch.materials import sample_reflective_diffuse
from rayaccel_tpu_torch.ops.trace_dense import trace_dense
from rayaccel_tpu_torch.ops.trace_sparse import trace_sparse
from rayaccel_tpu_torch.render.shading import (SECONDARY_TMAX, SECONDARY_TMIN,
                                               merge_rays, spawn_secondary,
                                               surface_from_attrs)
from rayaccel_tpu_torch.render.tiled import TiledRenderer
from rayaccel_tpu_torch.scene.clusters import ClusterScene, compile_clusters
from rayaccel_tpu_torch.scene.data import SceneData
from rayaccel_tpu_torch.types import INVALID_TRIANGLE, Rays

# Piece rows carrying this lane value are live-lane duplicates emitted by
# the fast shrink; reassembly skips them.
_LANE_INVALID = 3e38


def pt_shade(surf, rays, weight, key, lane=None):
    """One shading step given a surface frame. Returns (new_rays,
    new_weight, ok). With ``lane``, the BSDF draws are keyed per lane id
    (placement-invariant); otherwise positional."""
    if lane is not None:
        rnd = rng.lane_uniform(key, lane)
    else:
        rnd = rng.uniform(key, (rays.o.shape[0], 3), device=rays.o.device)
    wo = -rays.d
    wi, color, transmitted = sample_reflective_diffuse(
        surf.mat_params, rnd, surf.ns, wo)
    new_weight = weight * color
    new_rays, ok = spawn_secondary(surf, wi, new_weight, transmitted,
                                   surf.d_dot_ng)
    return new_rays, new_weight, ok


def _trace_and_surface(scene, rays, alive, bk, tile, opts=EngineOpts(),
                       env=None):
    """One closest-hit trace on engine ``bk`` ("pallas": the dense
    work-queue engine; "sparse": the pair engine) and the shading frame.
    With ``env``, the environment's radiance along active misses is folded
    into ``hits.miss_rgb``. Returns (hits, surf, overflow)."""
    if bk == "pallas":
        res, overflow = trace_dense(scene, rays, env=env, active=alive,
                                    tile=tile, k_step=opts.k_step,
                                    tile_cap=opts.tile_cap)
    elif bk == "sparse":
        res, overflow = trace_sparse(
            scene, rays, env=env, active=alive, k_pairs=opts.k_pairs,
            pair_budget=opts.pair_budget, sp_tile=opts.sp_tile,
            max_passes=opts.max_passes, k_first=opts.k_first,
            k_restart=opts.k_restart)
    else:
        raise NotImplementedError(
            f"engine {bk!r} is ROADMAP queue 1 item 12")
    surf = surface_from_attrs(res.attrs, scene.mat_params, rays, res.hits)
    return res.hits, surf, overflow


def _shade_advance(hits, surf, rays, weight, depth, alive, miss_d, miss_w,
                   skey, max_depth, lane=None):
    """Post-trace lane-state advance: terminal-miss capture, depth
    budgeting, BSDF sample + continuation spawn. Returns (rays, weight,
    depth, alive, miss_d, miss_w)."""
    miss = alive & (hits.tri == INVALID_TRIANGLE)
    miss_d = torch.where(miss[:, None], rays.d, miss_d)
    miss_w = torch.where(miss[:, None], weight, miss_w)

    active = alive & (hits.tri >= 0) & (depth < max_depth)
    new_rays, new_weight, ok = pt_shade(surf, rays, weight, skey, lane)
    alive2 = active & ok
    rays2 = merge_rays(alive2, new_rays, rays)
    weight2 = torch.where(alive2[:, None], new_weight, weight)
    depth2 = depth + active.to(torch.int32)
    return rays2, weight2, depth2, alive2, miss_d, miss_w


def _primary_rays(cam_arrays, x, y, wave_key):
    """Per-wave primary rays with uniform jitter."""
    return generate_pixel_rays(cam_arrays, x, y,
                               key=rng.fold_in(wave_key, 0))


def _stage1(scene, cam_arrays, xs, ys, alives, key, max_depth, backend,
            tile, opts):
    """Primary trace + first shade, wave by wave, pooled into frame-order
    lane state. Returns (state dict, overflow)."""
    W, R = xs.shape
    device = xs.device
    live_waves = alives.any(dim=1).tolist()
    cols = []
    overflow = torch.zeros((), dtype=torch.int64, device=device)
    for w in range(W):
        wkey = rng.fold_in(key, w)
        rays = _primary_rays(cam_arrays, xs[w], ys[w], wkey)
        alive0 = alives[w]
        zero3 = torch.zeros((R, 3), dtype=torch.float32, device=device)
        ones3 = torch.ones((R, 3), dtype=torch.float32, device=device)
        depth0 = torch.zeros((R,), dtype=torch.int32, device=device)
        if live_waves[w]:
            hits, surf, ov = _trace_and_surface(scene, rays, alive0, backend,
                                                tile, opts)
            cols.append(_shade_advance(hits, surf, rays, ones3, depth0,
                                       alive0, rays.d, zero3,
                                       rng.fold_in(wkey, 1), max_depth))
            overflow = overflow + ov
        else:
            cols.append((rays, ones3, depth0, alive0, rays.d, zero3))
    rays_c = [c[0] for c in cols]
    state = dict(
        rays=Rays(*(torch.cat([getattr(r, f) for r in rays_c])
                    for f in Rays._fields)),
        weight=torch.cat([c[1] for c in cols]),
        depth=torch.cat([c[2] for c in cols]),
        alive=torch.cat([c[3] for c in cols]),
        miss_d=torch.cat([c[4] for c in cols]),
        miss_w=torch.cat([c[5] for c in cols]),
    )
    return state, overflow


def _shrink(alive, lane, n_fresh: int, nxt: int, cols):
    """The width shrink of a pooled bounce loop. Returns (perm, piece):
    the first ``nxt`` positions of a stable live-first order (the new
    head), and the piece the pool leaves behind: at every position, the
    lane id and ``cols`` where the lane is fresh (below ``n_fresh``, so
    alive when the stage began) and dead now, ``_LANE_INVALID`` elsewhere,
    so that each dead lane is emitted exactly once."""
    iota = torch.arange(alive.shape[0], dtype=torch.int32,
                        device=alive.device)
    perm = torch.argsort(torch.where(alive, iota, 0x7FFFFFFF),
                         stable=True)[:nxt]
    valid = (iota < n_fresh) & ~alive
    piece = torch.cat([torch.where(valid, lane.to(torch.float32),
                                   _LANE_INVALID)[:, None], *cols], dim=1)
    return perm, piece


def _final_piece(lane, n_fresh: int, shrunk: bool, cols):
    """The last stage's piece. After a shrink, the rows at or past
    ``n_fresh`` are dead filler hauled into the head, emitted in an
    earlier piece: they are marked invalid."""
    final = lane.to(torch.float32)
    if shrunk:
        final = torch.where(torch.arange(final.shape[0], device=lane.device)
                            < n_fresh, final, _LANE_INVALID)
    return torch.cat([final[:, None], *cols], dim=1)


def _by_lane(lane_f, rows, N: int):
    """(N, cols): each valid piece row scattered to its lane id."""
    real = lane_f < _LANE_INVALID
    out = torch.zeros((N, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    out[lane_f[real].to(torch.int64)] = rows[real]
    return out


def _stage_widths(N: int, max_depth: int, min_stage_width: int):
    """Width-shrink ladder: quarter the pool while it stays above the
    floor, at most ``max_depth`` stages (bounce b runs in stage <= b)."""
    widths = [N]
    while len(widths) < max_depth and widths[-1] // 4 >= min_stage_width:
        widths.append(-(-widths[-1] // 4 // 1024) * 1024)
    return widths


def pt_trace_frame(scene: ClusterScene, env: Environment, cam_arrays,
                   xs: torch.Tensor, ys: torch.Tensor, alives: torch.Tensor,
                   key, max_depth: int, backend: str = "pallas",
                   tile: int = 512, bounce_backend: str = "sparse",
                   min_stage_width: int = 8192, opts: EngineOpts = EngineOpts()):
    """Trace a whole frame with one pooled bounce loop.

    1. Primaries are traced and shaded wave by wave (dense engine).
    2. All surviving lanes are pooled in frame order and run one bounce
       loop (sparse engine); when the live set fits the next stage width
       (a quarter), the pool shrinks once: live lanes move to the head,
       and the lanes left behind emit their (lane, miss_d, miss_w) rows as
       a piece at full width, with rows that must not contribute marked
       invalid.
    3. One deferred environment lookup over all pieces, reassembled by
       lane id.

    Returns (radiance (W, R, 3) in lane order, traced, dropped)."""
    W, R = xs.shape
    N = W * R
    assert N < (1 << 24), f"frame pool {N} >= 2^24 lanes"
    device = xs.device

    state, dropped = _stage1(scene, cam_arrays, xs, ys, alives, key,
                             max_depth, backend, tile, opts)
    traced = alives.sum()
    state["lane"] = torch.arange(N, dtype=torch.int32, device=device)
    state["n_fresh"] = N
    bounce = 0

    def bounce_body(st):
        nonlocal traced, dropped, bounce
        traced = traced + st["alive"].sum()
        hits, surf, ov = _trace_and_surface(scene, st["rays"], st["alive"],
                                            bounce_backend, tile, opts)
        dropped = dropped + ov
        skey = rng.fold_in(key, 4096 + bounce)
        bounce += 1
        rays2, weight2, depth2, alive2, miss_d2, miss_w2 = _shade_advance(
            hits, surf, st["rays"], st["weight"], st["depth"], st["alive"],
            st["miss_d"], st["miss_w"], skey, max_depth, lane=st["lane"])
        return dict(st, rays=rays2, weight=weight2, depth=depth2,
                    alive=alive2, miss_d=miss_d2, miss_w=miss_w2)

    stage_widths = _stage_widths(N, max_depth, min_stage_width)
    pieces = []
    st = state
    for nxt in [*stage_widths[1:], None]:
        while True:
            n_live = int(st["alive"].sum())
            if n_live == 0 or (nxt is not None and n_live <= nxt):
                break
            st = bounce_body(st)
        if nxt is None:
            break
        perm, piece = _shrink(st["alive"], st["lane"], st["n_fresh"], nxt,
                              (st["miss_d"], st["miss_w"]))
        pieces.append(piece)
        r = st["rays"]
        d_h = r.d[perm]
        st = dict(
            rays=Rays(r.o[perm], d_h,
                      torch.full((nxt,), SECONDARY_TMIN, dtype=torch.float32,
                                 device=device),
                      torch.full((nxt,), SECONDARY_TMAX, dtype=torch.float32,
                                 device=device)),
            weight=st["weight"][perm], miss_d=d_h,
            miss_w=torch.zeros((nxt, 3), dtype=torch.float32, device=device),
            depth=st["depth"][perm],
            alive=torch.arange(nxt, device=device) < n_live,
            lane=st["lane"][perm], n_fresh=n_live)
    pieces.append(_final_piece(st["lane"], st["n_fresh"],
                               len(stage_widths) > 1,
                               (st["miss_d"], st["miss_w"])))

    # ---- stage 3: deferred env lookup + reassembly by lane id ----
    allp = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    miss_w = allp[:, 4:7]
    # Rows with miss_w == 0 multiply the sample by zero: look them all up
    # in one direction.
    is_miss = (miss_w[:, 0] + miss_w[:, 1] + miss_w[:, 2]) > 0
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=device)
    miss_dir = torch.where(is_miss[:, None], allp[:, 1:4], up)
    radiance = miss_w * sample_environment(env, miss_dir)
    rad = _by_lane(allp[:, 0], radiance, N)
    return rad.reshape(W, R, 3), traced, dropped


class PathTracingRenderer(TiledRenderer):
    """Progressive frame-pooled path tracer over a compiled cluster scene:
    dense work-queue engine for primaries, sparse pair engine for bounces
    (hybrid routing; without ``hybrid_tracing`` the dense engine traces
    bounces too)."""

    def __init__(self, context: Context, camera: Camera, scene_data: SceneData,
                 cluster_scene: ClusterScene | None = None,
                 environment: Environment | None = None):
        super().__init__(context, scene_data.viewport_width,
                         scene_data.viewport_height)
        cfg = context.configuration
        self.camera = camera
        self.scene_data = scene_data
        self.backend = cfg.backend
        self.scene = (cluster_scene if cluster_scene is not None
                      else compile_clusters(scene_data, device=self.device))
        self.bounce_backend = "sparse" if cfg.hybrid_tracing else self.backend
        if environment is None:
            env_px = scene_data.env_pixels
            assert env_px is not None, "scene has no environment probe"
            environment = create_environment(env_px, env_px.shape[1],
                                             env_px.shape[0],
                                             device=self.device)
        self.environment = environment
        self.max_depth = int(scene_data.max_depth)
        self.opts = cfg.engine_opts()
        self.tile = min(cfg.trace_block, self.wave_size)
        self.min_stage_width = cfg.min_stage_width

    def _render(self, key):
        return pt_trace_frame(
            self.scene, self.environment, self.camera.as_arrays(self.device),
            self._wave_x, self._wave_y, self._wave_alive, key, self.max_depth,
            backend=self.backend, tile=self.tile,
            bounce_backend=self.bounce_backend,
            min_stage_width=self.min_stage_width, opts=self.opts)
