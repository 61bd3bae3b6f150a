"""Wavefront path tracer: per wave, and frame-pooled.

Counterpart of ``rayaccel_tpu/render/pathtracer.py``: ``pt_shade``,
``_trace_and_surface`` (the ``"pallas"``, ``"sparse"``, ``"mxu"`` and
``"xla"`` engines), ``_shade_advance``, ``_primary_rays`` with the uniform
and the stratified sampler, ``pt_trace_wave`` (``:188-333``, one wave
traced to completion; the port runs it without the JAX function's
between-bounce regroup, which changes no radiance bit: the draws are keyed
per lane id), ``pt_trace_frame`` (``:361-669``) with the fast width shrink
(``render/pool.py``), on one device or on one rank of a mesh with the
cross-rank reshard, and ``PathTracingRenderer``, which takes the pooled
frame when the configuration regroups on a cluster engine and the
per-wave body otherwise. The random streams follow the JAX key chains
exactly. Pooled: stage 1 draws positionally from ``fold_in(key, w)``
(camera jitter from ``fold_in(wkey, 0)``, the first BSDF sample from
``fold_in(wkey, 1)``; under a mesh ``key`` is ``fold_in(key, rank)``
here), bounce b draws per global lane id from ``fold_in(key, 4096 + b)``.
Per wave, with ``wave_key = fold_in(key, w)``: jitter from
``fold_in(wave_key, 0)``, bounce b per wave-local lane id from
``fold_in(wave_key, b + 1)``.

The JAX function is one compiled program with ``lax.scan`` /
``while_loop`` / ``cond``; here the same control flow runs eagerly, with
the loop conditions read on the host.

The benchmark's layer spans wrap this module's ``trace_dense``,
``trace_sparse`` and ``sample_environment`` (``rtbench/layers/``): the
calls look them up here at call time, rays second, ``active=`` by keyword.
"""

from __future__ import annotations

import numpy as np
import torch

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.camera import Camera, generate_pixel_rays
from rayaccel_tpu_torch.config import EngineOpts
from rayaccel_tpu_torch.context import Context
from rayaccel_tpu_torch.environment import Environment, sample_environment
from rayaccel_tpu_torch.materials import sample_reflective_diffuse
from rayaccel_tpu_torch.ops.trace import trace_bvh
from rayaccel_tpu_torch.ops.trace_dense import trace_dense
from rayaccel_tpu_torch.ops.trace_mxu import trace_mxu
from rayaccel_tpu_torch.ops.trace_sparse import trace_sparse
from rayaccel_tpu_torch.parallel.mesh import Mesh, reshard_balance_cols
from rayaccel_tpu_torch.render.pool import (by_lane, first_lane, read_any,
                                           run_pool)
from rayaccel_tpu_torch.render.shading import (interpolate_surface,
                                               merge_rays, secondary_rays,
                                               spawn_secondary,
                                               surface_from_attrs)
from rayaccel_tpu_torch.render.tiled import TiledRenderer
from rayaccel_tpu_torch.scene.clusters import ClusterScene
from rayaccel_tpu_torch.scene.data import SceneData
from rayaccel_tpu_torch.types import INVALID_TRIANGLE, Rays
from rayaccel_tpu_torch.utils.spans import span

SAMPLER_SEED = 0x5EED      # the stratified sampler's per-pixel rotation key
_R2 = (0.7548776662466927, 0.5698402909980532)   # plastic-constant R2


def pt_shade(surf, rays, weight, key, lane=None):
    """One shading step given a surface frame. Returns (new_rays,
    new_weight, ok). With ``lane``, the BSDF draws are keyed per lane id
    (placement-invariant); otherwise positional."""
    if lane is not None:
        rnd = rng.lane_uniform(key, lane)
    else:
        rnd = rng.uniform(key, (rays.o.shape[0], 3), device=rays.o.device)
    wo = -rays.d
    with span("racc.shade.bsdf"):
        wi, color, transmitted = sample_reflective_diffuse(
            surf.mat_params, rnd, surf.ns, wo)
    new_weight = weight * color
    new_rays, ok = spawn_secondary(surf, wi, new_weight, transmitted,
                                   surf.d_dot_ng)
    return new_rays, new_weight, ok


def _trace_and_surface(scene, rays, alive, bk, tile, opts=EngineOpts(),
                       env=None, stack_depth: int = 48):
    """One closest-hit trace on engine ``bk`` and the shading frame:
    "pallas" the dense work-queue engine, "sparse" the pair engine, "mxu"
    the plain cluster engine (all over a ClusterScene), "xla" the lockstep
    BVH engine (over a TpuScene, its frame built by gathers). With ``env``,
    the environment's radiance along active misses is folded into
    ``hits.miss_rgb``. Returns (hits, surf, overflow)."""
    if bk == "xla":
        hits = trace_bvh(scene, rays, env=env, active=alive,
                         stack_depth=stack_depth)
        with span("racc.shade.surface"):
            surf = interpolate_surface(scene, rays, hits,
                                       alive & (hits.tri >= 0))
        return hits, surf, 0
    if bk == "pallas":
        res, overflow = trace_dense(scene, rays, env=env, active=alive,
                                    tile=tile, **opts.dense_kwargs())
    elif bk == "sparse":
        res, overflow = trace_sparse(scene, rays, env=env, active=alive,
                                     k_first=opts.k_first,
                                     **opts.sparse_kwargs())
    elif bk == "mxu":
        res, overflow = trace_mxu(scene, rays, env=env, active=alive,
                                  tile=tile), 0
    else:
        raise ValueError(f"no renderer runs on engine {bk!r}")
    with span("racc.shade.surface"):
        surf = surface_from_attrs(res.attrs, scene.mat_params, rays,
                                  res.hits)
    return res.hits, surf, overflow


def _shade_advance(hits, surf, rays, weight, depth, alive, miss_d, miss_w,
                   skey, max_depth, lane=None):
    """Post-trace lane-state advance: terminal-miss capture, depth
    budgeting, BSDF sample + continuation spawn. Returns (rays, weight,
    depth, alive, miss_d, miss_w)."""
    with span("racc.shade"):
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


def _stratified_jitter(x, y, spp_index, sampler_key):
    """The stratified sampler's sub-pixel offsets: the progressive R2
    low-discrepancy sequence advanced per sample ``spp_index`` and rotated
    per pixel by a frame-independent random offset (a function of the
    pixel, not the lane: waves reuse lane offsets). Returns (rot (R, 2),
    jx, jy)."""
    pix = (y.to(torch.int32) << 16) | x.to(torch.int32)
    rot = rng.fold_in_uniform_pair(sampler_key, pix)
    s_f = np.float32(int(spp_index))
    # The products are rounded to float32 on the host, as the device would
    # round them.
    jx = torch.remainder(rot[:, 0] + float(s_f * np.float32(_R2[0])), 1.0)
    jy = torch.remainder(rot[:, 1] + float(s_f * np.float32(_R2[1])), 1.0)
    return rot, jx, jy


def _primary_rays(cam_arrays, x, y, wave_key, sampler="uniform",
                  spp_index=None, sampler_key=None):
    """Per-wave primary rays: uniform jitter from ``fold_in(wave_key, 0)``,
    or the stratified sampler's."""
    if sampler == "stratified":
        assert spp_index is not None and sampler_key is not None
        _, jx, jy = _stratified_jitter(x, y, spp_index, sampler_key)
        return generate_pixel_rays(cam_arrays, x, y, jitter=(jx, jy))
    return generate_pixel_rays(cam_arrays, x, y,
                               key=rng.fold_in(wave_key, 0))


def pt_trace_wave(scene, env: Environment, cam_arrays, x: torch.Tensor,
                  y: torch.Tensor, alive0: torch.Tensor, key, max_depth: int,
                  backend: str = "pallas", tile: int = 512,
                  stack_depth: int = 48, sampler: str = "uniform",
                  spp_index=None, sampler_key=None,
                  bounce_backend: str | None = None,
                  opts: EngineOpts = EngineOpts()):
    """Trace one wave of pixels to completion (all bounces): the primary
    trace on ``backend``, then bounces on ``bounce_backend`` while any lane
    is alive. The BSDF draws are keyed per lane id.

    Returns (radiance (R, 3), traced, dropped): ``dropped`` counts the
    dense and sparse engines' overflow (0 elsewhere).

    The engine defaults to ``backend="pallas"``, the port's kernel path. The
    JAX package's ``pt_trace_wave`` defaults to "mxu", which in the port is
    the plain ``torch.bmm`` engine, so a call that leaves ``backend`` out
    runs another engine in each package; the renderers always pass theirs."""
    R = x.shape[0]
    device = x.device
    if bounce_backend is None:
        bounce_backend = backend
    rays = _primary_rays(cam_arrays, x, y, key, sampler, spp_index,
                         sampler_key)
    traced = dropped = torch.zeros((), dtype=torch.int64, device=device)
    weight = torch.ones_like(rays.o)
    depth = torch.zeros((R,), dtype=torch.int32, device=device)
    alive = alive0
    lane = torch.arange(R, dtype=torch.int32, device=device)
    miss_d, miss_w = rays.d, torch.zeros_like(rays.o)
    bounce = 0
    while read_any(alive, "racc.render.read.wave_alive"):
        with span("racc.render.loop"):
            hits, surf, ov = _trace_and_surface(
                scene, rays, alive, backend if bounce == 0 else bounce_backend,
                tile, opts, stack_depth=stack_depth)
            traced = traced + alive.sum()
            dropped = dropped + ov
            rays, weight, depth, alive, miss_d, miss_w = _shade_advance(
                hits, surf, rays, weight, depth, alive, miss_d, miss_w,
                rng.fold_in(key, bounce + 1), max_depth, lane=lane)
            bounce += 1

    with span("racc.render.assemble"):
        radiance = miss_w * sample_environment(env, miss_d)
    return radiance, traced, dropped


def _stage1(scene, cam_arrays, xs, ys, alives, key, max_depth, backend,
            tile, opts, sampler=("uniform", None, None)):
    """Primary trace + first shade, wave by wave, pooled into frame-order
    lane state. Returns (state dict, overflow)."""
    W, R = xs.shape
    device = xs.device
    with span("racc.render.read.live_waves"):
        live_waves = alives.any(dim=1).tolist()
    cols = []
    overflow = torch.zeros((), dtype=torch.int64, device=device)
    for w in range(W):
        with span("racc.render.wave"):
            wkey = rng.fold_in(key, w)
            rays = _primary_rays(cam_arrays, xs[w], ys[w], wkey, *sampler)
            alive0 = alives[w]
            zero3 = torch.zeros((R, 3), dtype=torch.float32, device=device)
            ones3 = torch.ones((R, 3), dtype=torch.float32, device=device)
            depth0 = torch.zeros((R,), dtype=torch.int32, device=device)
            if live_waves[w]:
                hits, surf, ov = _trace_and_surface(scene, rays, alive0,
                                                    backend, tile, opts)
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


def _reshard_balance(st, mesh: Mesh, D: int):
    """Cross-rank bounce balance of the PT pool: the shared striped exchange
    (``parallel/mesh.py:reshard_balance_cols``) over the 19 lane-state
    columns. Lane ids are global and the bounce draws are keyed by them,
    so the radiance is bitwise the same whether it fires or not. Returns
    (state, resharded)."""
    r = st["rays"]
    S = torch.cat([r.o, r.d, r.tmin[:, None], r.tmax[:, None], st["weight"],
                   st["miss_d"], st["miss_w"],
                   st["depth"].to(torch.float32)[:, None],
                   st["alive"].to(torch.float32)[:, None]], dim=1)
    S, lane, resharded = reshard_balance_cols(S, st["lane"], st["alive"],
                                              mesh, D)
    return dict(st, rays=Rays(S[:, 0:3], S[:, 3:6], S[:, 6], S[:, 7]),
                weight=S[:, 8:11], miss_d=S[:, 11:14], miss_w=S[:, 14:17],
                depth=S[:, 17].to(torch.int32), alive=S[:, 18] > 0,
                lane=lane), resharded


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
                   min_stage_width: int = 8192, opts: EngineOpts = EngineOpts(),
                   sampler: str = "uniform", spp_index=None,
                   sampler_key=None, mesh: Mesh | None = None,
                   n_shards: int = 1, reshard: bool = True,
                   info: dict | None = None):
    """Trace a whole frame with one pooled bounce loop (cluster engines).

    1. Primaries are traced and shaded wave by wave (dense engine).
    2. All surviving lanes are pooled in frame order and run one bounce
       loop (sparse engine); when the live set fits the next stage width
       (a quarter), the pool shrinks once: live lanes move to the head,
       and the lanes left behind emit their (lane, miss_d, miss_w) rows as
       a piece at full width, with rows that must not contribute marked
       invalid.
    3. One deferred environment lookup over all pieces, reassembled by
       lane id.

    With ``mesh`` (of ``n_shards`` ranks), ``xs``, ``ys`` and ``alives``
    are this rank's lanes of each wave, stage 1 draws from ``fold_in(key,
    rank)``, and lane ids are global (rank * N + local). With ``reshard``
    and more than one rank, the pools are balanced across the ranks once
    before the bounce loop (every rank must enter it, dead or not), and
    the radiance of lanes traced away from home is routed home at
    reassembly.

    Returns (radiance (W, R, 3) in lane order, traced, dropped): this
    rank's. With ``info``, whether the reshard fired is written to it.

    The engine defaults to ``backend="pallas"``, the port's kernel path. The
    JAX package's ``pt_trace_frame`` defaults to "mxu", which in the port is
    the plain ``torch.bmm`` engine, so a call that leaves ``backend`` out
    runs another engine in each package; the renderers always pass theirs."""
    W, R = xs.shape
    N = W * R
    lane0 = first_lane(N, mesh, n_shards)
    device = xs.device
    wave_key = key if mesh is None else rng.fold_in(key, mesh.rank)

    with span("racc.render.stage1"):
        state, dropped = _stage1(scene, cam_arrays, xs, ys, alives,
                                 wave_key, max_depth, backend, tile, opts,
                                 (sampler, spp_index, sampler_key))
    traced = alives.sum()
    state["lane"] = torch.arange(lane0, lane0 + N, dtype=torch.int32,
                                 device=device)
    resharded = False
    if mesh is not None and n_shards > 1 and reshard:
        with span("racc.render.exchange"):
            state, resharded = _reshard_balance(state, mesh, n_shards)
    if info is not None:
        info["resharded"] = resharded
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

    def narrow(st, perm, n_live):
        nxt = perm.shape[0]
        d_h = st["rays"].d[perm]
        return dict(
            rays=secondary_rays(st["rays"].o[perm], d_h),
            weight=st["weight"][perm], miss_d=d_h,
            miss_w=torch.zeros((nxt, 3), dtype=torch.float32, device=device),
            depth=st["depth"][perm],
            alive=torch.arange(nxt, device=device) < n_live,
            lane=st["lane"][perm])

    _, allp, _ = run_pool(state, _stage_widths(N, max_depth, min_stage_width),
                          bounce_body, narrow,
                          lambda st: (st["miss_d"], st["miss_w"]))

    # ---- stage 3: deferred env lookup + reassembly by lane id ----
    with span("racc.render.assemble"):
        miss_w = allp[:, 4:7]
        # Rows with miss_w == 0 multiply the sample by zero: look them all
        # up in one direction.
        is_miss = (miss_w[:, 0] + miss_w[:, 1] + miss_w[:, 2]) > 0
        with span("racc.render.read.up"):
            up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                              device=device)
        miss_dir = torch.where(is_miss[:, None], allp[:, 1:4], up)
        radiance = miss_w * sample_environment(env, miss_dir)
        rad = by_lane(allp[:, 0], radiance, N, lane0, mesh, resharded)
    return rad.reshape(W, R, 3), traced, dropped


class PathTracingRenderer(TiledRenderer):
    """Progressive wavefront path tracer over a compiled scene
    (``TiledRenderer._setup``: the engines, under ``hybrid_tracing`` the
    dense engines' bounces on the sparse pair engine). With ``regroup`` on
    a cluster engine the frame runs on the pooled bounce loop
    (:func:`pt_trace_frame`), otherwise wave by wave (:func:`pt_trace_wave`).

    ``tpu_scene`` may be a ClusterScene or a TpuScene; without one the
    scene is compiled for the backend. The "bruteforce" oracle runs no
    renderer (``ops/trace.py:trace`` serves it). Under a mesh every rank
    traces rank 0's scene and environment (``replicate_scene``) and its
    own lanes of each wave; the pooled frame balances the ranks' bounce
    pools when ``reshard_bounces`` is set."""

    def __init__(self, context: Context, camera: Camera, scene_data: SceneData,
                 tpu_scene=None, environment: Environment | None = None):
        super().__init__(context, scene_data.viewport_width,
                         scene_data.viewport_height)
        self._setup(camera, scene_data, tpu_scene, environment)
        self.sampler = context.configuration.sampler
        self._sampler_key = rng.PRNGKey(SAMPLER_SEED)

    def _render(self, key):
        if not self.pooled:
            return super()._render(key)
        return pt_trace_frame(
            self.scene, self.environment, self._camera_arrays(),
            self._wave_x, self._wave_y, self._wave_alive, key, self.max_depth,
            backend=self.backend, tile=self.tile,
            bounce_backend=self.bounce_backend,
            min_stage_width=self.min_stage_width, opts=self.opts,
            sampler=self.sampler, spp_index=self.spp,
            sampler_key=self._sampler_key, **self._mesh_kwargs())

    def _trace_wave(self, x, y, alive, wave_key):
        return pt_trace_wave(
            self.scene, self.environment, self._camera_arrays(),
            x, y, alive, wave_key, self.max_depth, backend=self.backend,
            tile=self.tile, stack_depth=self.stack_depth,
            sampler=self.sampler, spp_index=self.spp,
            sampler_key=self._sampler_key,
            bounce_backend=self.bounce_backend, opts=self.opts)
