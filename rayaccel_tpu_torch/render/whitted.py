"""Wavefront Whitted renderer: ray trees with lane-local parked stacks.

Counterpart of ``rayaccel_tpu/render/whitted.py``: ``whitted_shade``
(``:57-107``) and its constants (``:52-54``), ``_occlusion_query``
(``:110-142``, every engine), the trace of ``_whitted_trace``
(``:145-178``, through ``pathtracer._trace_and_surface`` with the
environment folded at trace time), ``_whitted_step`` (``:181-274``),
``whitted_trace_wave`` (``:277-420``; the port runs it without the JAX
function's between-bounce regroup, which Whitted shading, deterministic,
does not see), ``whitted_trace_frame`` (``:423-768``) with the fast shrink
(``render/pool.py``) and the scanned dense bounce, on one device or on one
rank of a mesh with the cross-rank reshard, and ``WhittedRenderer``
(``:771-891``).

Each wavefront lane owns one pixel's whole ray tree. When a hit spawns
both a reflection and a refraction ray, the reflection continues and the
refraction is parked on the lane's stack; when a lane's path terminates,
its top parked ray resumes. The stacks are (S, 7, R) [o, d, depth] and
(S, 3, R) [weight]; a push writes and a pop reads the level ``sp`` by a
gather/scatter, which selects the same values as the JAX one-hot level
blend. Parks beyond the stack are counted in ``dropped``.

Decided difference: the dense shadow query reports its queue-clamp
overflow (``ops/trace_dense.py:trace_occlusion_dense``) and this module
adds it to ``dropped``; the JAX function returns 0 there (``:118-124``).

The JAX functions are compiled programs with ``lax.scan`` /
``while_loop`` / ``cond``; here the same control flow runs eagerly, with
every loop condition read on the host.

The benchmark's layer spans wrap this module's ``trace_occlusion_dense``
and ``trace_occlusion_sparse`` and, through ``_trace_and_surface``,
``pathtracer``'s closest-hit engines (``rtbench/layers/``): the calls look
them up in those modules at call time, rays second, ``active=`` by keyword.
"""

from __future__ import annotations

import numpy as np
import torch

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.camera import Camera, generate_pixel_rays
from rayaccel_tpu_torch.config import EngineOpts
from rayaccel_tpu_torch.context import Context
from rayaccel_tpu_torch.environment import Environment
from rayaccel_tpu_torch.ops.intersect import dot3
from rayaccel_tpu_torch.ops.trace import trace_occlusion_bvh
from rayaccel_tpu_torch.ops.trace_dense import trace_occlusion_dense
from rayaccel_tpu_torch.ops.trace_mxu import trace_occlusion_mxu
from rayaccel_tpu_torch.ops.trace_sparse import trace_occlusion_sparse
from rayaccel_tpu_torch.parallel.mesh import Mesh, reshard_balance_cols
from rayaccel_tpu_torch.render.pathtracer import _trace_and_surface
from rayaccel_tpu_torch.render.pool import (by_lane, first_lane, read_any,
                                           run_pool)
from rayaccel_tpu_torch.render.shading import (ORIGIN_EPSILON, WEIGHT_CUTOFF,
                                               SurfaceSample, merge_rays,
                                               secondary_rays)
from rayaccel_tpu_torch.render.tiled import TiledRenderer
from rayaccel_tpu_torch.scene.clusters import ClusterScene
from rayaccel_tpu_torch.scene.data import SceneData
from rayaccel_tpu_torch.types import INVALID_TRIANGLE, Hits, Rays
from rayaccel_tpu_torch.utils.spans import span

MATERIAL_GRAY = 0.3                      # WhittedRenderer.cpp:343-345
LIGHT_DIR = (0.57, 0.57, 0.57)           # WhittedRenderer.cpp:357-359
ETA_GLASS = 1.1                          # WhittedRenderer.cpp:429-430

# The light direction and its normalised form, rounded to float32 as the
# JAX function computes them, held as Python floats (a float32 tensor op
# with a Python float rounds it to float32 exactly).
_LIGHT = np.float32(LIGHT_DIR)
_LIGHT_UNIT = _LIGHT / np.sqrt(np.float32(_LIGHT[0] * _LIGHT[0]
                                          + _LIGHT[1] * _LIGHT[1]
                                          + _LIGHT[2] * _LIGHT[2]))
_LIGHT, _LIGHT_UNIT = _LIGHT.tolist(), _LIGHT_UNIT.tolist()


def _dot_const(a: torch.Tensor, c) -> torch.Tensor:
    """Row-wise dot product of (R, 3) with a constant 3-vector."""
    return a[:, 0] * c[0] + a[:, 1] * c[1] + a[:, 2] * c[2]


def whitted_shade(surf, rays: Rays, weight: torch.Tensor):
    """Direct radiance and both child rays of each hit, given its shading
    frame. Returns (radiance, new_weight, refl_rays, refl_ok, refr_rays,
    refr_ok)."""
    d = rays.d
    ns = surf.ns  # already flipped toward the incoming ray
    ndotl = torch.clamp_min(_dot_const(ns, _LIGHT), 0.0)
    new_weight = weight * MATERIAL_GRAY
    radiance = new_weight * ndotl[:, None]
    cont = torch.any(new_weight > WEIGHT_CUTOFF, dim=-1)

    d_dot_n = dot3(d, ns)
    refl_d = d - (2.0 * d_dot_n)[:, None] * ns
    # Refraction: eta by travel side (entering uses 1/1.1).
    eta = torch.where(surf.entering, 1.0 / ETA_GLASS, ETA_GLASS).to(
        torch.float32)
    r = 1.0 - eta * eta * (1.0 - d_dot_n * d_dot_n)
    mu = eta * d_dot_n + torch.sqrt(torch.clamp_min(r, 0.0))
    refr_d = eta[:, None] * d - mu[:, None] * ns

    d_side = surf.d_dot_ng > 0

    def finish(dir_new, extra_ok):
        dot = dot3(dir_new, surf.ng)
        pos = surf.pos + surf.ng * torch.where(
            dot >= 0, ORIGIN_EPSILON, -ORIGIN_EPSILON)[:, None]
        finite = (torch.isfinite(pos).all(dim=-1)
                  & torch.isfinite(dir_new).all(dim=-1))
        return secondary_rays(pos, dir_new), cont & extra_ok & finite, dot > 0

    refl_rays, refl_base, refl_side = finish(refl_d, True)
    refr_rays, refr_base, refr_side = finish(refr_d, r > 0.0)
    # Side consistency: reflection leaves on the opposite side of Ng,
    # refraction on the same side.
    refl_ok = refl_base & (refl_side != d_side)
    refr_ok = refr_base & (refr_side == d_side)
    return radiance, new_weight, refl_rays, refl_ok, refr_rays, refr_ok


def shadow_rays(surf) -> Rays:
    """Shadow rays toward the directional light, from each hit point
    offset along Ng to the light's side, over [SECONDARY_TMIN,
    SECONDARY_TMAX]."""
    sgn = torch.where(_dot_const(surf.ng, _LIGHT_UNIT) >= 0, ORIGIN_EPSILON,
                      -ORIGIN_EPSILON)
    spos = surf.pos + surf.ng * sgn[:, None]
    with span("racc.shade.read.light"):
        d = torch.tensor(_LIGHT_UNIT, dtype=torch.float32).to(spos.device)
    return secondary_rays(spos, d.expand_as(spos).contiguous())


def _occlusion_query(scene, srays: Rays, active, bk: str, tile: int,
                     opts: EngineOpts = EngineOpts(), stack_depth: int = 48):
    """Any-hit shadow query on engine ``bk``. Returns (occluded,
    uncounted): the dense engine's queue-clamp overflow or the sparse
    engine's under-resolved rays, which the caller adds to ``dropped``
    (the plain engines drop nothing)."""
    if bk == "pallas":
        return trace_occlusion_dense(scene, srays, active=active, tile=tile,
                                     **opts.dense_kwargs())
    if bk == "sparse":
        return trace_occlusion_sparse(scene, srays, active=active,
                                      **opts.sparse_kwargs())
    if bk == "mxu":
        return trace_occlusion_mxu(scene, srays, active=active, tile=tile), 0
    if bk == "xla":
        return trace_occlusion_bvh(scene, srays, active=active,
                                   stack_depth=stack_depth), 0
    raise ValueError(f"no renderer runs on engine {bk!r}")


def _initial_state(rays: Rays, alive, stack_size: int):
    """Fresh lane state: unit weight, depth 0, empty stacks."""
    R = rays.o.shape[0]
    dev = rays.o.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return dict(
        rays=rays, weight=torch.ones((R, 3), dtype=torch.float32, device=dev),
        depth=torch.zeros((R,), dtype=torch.int32, device=dev), alive=alive,
        sp=torch.zeros((R,), dtype=torch.int32, device=dev),
        stk=torch.zeros((stack_size, 7, R), dtype=torch.float32, device=dev),
        stk_w=torch.zeros((stack_size, 3, R), dtype=torch.float32,
                          device=dev),
        radiance=torch.zeros((R, 3), dtype=torch.float32, device=dev),
        traced=zero, dropped=zero)


def _whitted_step(scene, s, hits, surf, bk: str, tile: int, max_depth: int,
                  stack_size: int, shadows: bool, primary_only: bool,
                  opts: EngineOpts = EngineOpts(), stack_depth: int = 48):
    """Advance the lane state after a trace: environment on miss, direct
    light (with the optional shadow query), reflection and refraction
    spawn, refraction parking, and terminated-head pops. Writes the stacks
    of ``s`` in place; returns the advanced state dict."""
    rays, alive, weight, depth = s["rays"], s["alive"], s["weight"], s["depth"]
    R = rays.o.shape[0]
    lanes = torch.arange(R, device=rays.o.device)
    traced = s["traced"] + alive.sum()
    dropped = s["dropped"]

    miss = alive & (hits.tri == INVALID_TRIANGLE)
    radiance = s["radiance"] + torch.where(miss[:, None],
                                           weight * hits.miss_rgb, 0.0)

    # Hits at depth == max_depth terminate without contribution.
    active = alive & (hits.tri >= 0) & (depth < max_depth)
    with span("racc.shade.bsdf"):
        direct, new_w, refl, refl_ok, refr, refr_ok = whitted_shade(
            surf, rays, weight)
    if primary_only:
        # Primary + shadow rays only: no reflection or refraction trees.
        refl_ok = torch.zeros_like(refl_ok)
        refr_ok = torch.zeros_like(refr_ok)
    refl_ok = refl_ok & active
    refr_ok = refr_ok & active
    if shadows:
        # An occluded hit gets no direct light.
        occluded, uncounted = _occlusion_query(scene, shadow_rays(surf),
                                               active, bk, tile, opts,
                                               stack_depth)
        traced = traced + active.sum()
        direct = torch.where(occluded[:, None], 0.0, direct)
        dropped = dropped + uncounted
    radiance = radiance + torch.where(active[:, None], direct, 0.0)

    # Reflection continues; a lone refraction continues; both => park the
    # refraction.
    next_rays = merge_rays(refl_ok, refl, refr)
    has_next = refl_ok | refr_ok
    park = refl_ok & refr_ok

    stk, stk_w, sp = s["stk"], s["stk_w"], s["sp"]
    top = stk.shape[0] - 1     # the stacks may hold fewer levels than S
    can_park = park & (sp < stack_size)
    dropped = dropped + (park & ~can_park).sum()
    level = torch.clamp_max(sp, top).long()
    entry = torch.cat([refr.o, refr.d, (depth + 1).to(torch.float32)[:, None]],
                      dim=1)                                      # (R, 7)
    stk[level, :, lanes] = torch.where(can_park[:, None], entry,
                                       stk[level, :, lanes])
    stk_w[level, :, lanes] = torch.where(can_park[:, None], new_w,
                                         stk_w[level, :, lanes])
    sp = sp + can_park.to(torch.int32)

    # Termination => resume the top parked ray, else the lane dies.
    terminated = alive & ~has_next
    pop = terminated & (sp > 0)
    sp = sp - pop.to(torch.int32)
    level = torch.clamp_max(sp, top).long()
    pe = stk[level, :, lanes]                                     # (R, 7)
    pw = stk_w[level, :, lanes]                                   # (R, 3)
    popped = secondary_rays(pe[:, 0:3], pe[:, 3:6])

    alive_next = (active & has_next) | pop
    out_rays = merge_rays(pop, popped, merge_rays(has_next, next_rays, rays))
    out_w = torch.where(pop[:, None], pw,
                        torch.where(active[:, None], new_w, weight))
    out_depth = torch.where(pop, pe[:, 6].to(torch.int32),
                            depth + active.to(torch.int32))
    return dict(s, rays=out_rays, weight=out_w, depth=out_depth,
                alive=alive_next, sp=sp, stk=stk, stk_w=stk_w,
                radiance=radiance, traced=traced, dropped=dropped)


def _trace_scanned(trace_fn, rays: Rays, alive, scan: int):
    """``trace_fn(rays, alive)`` over consecutive slices of ``scan`` lanes:
    the slices' hits and frames concatenated, their overflow summed (the
    JAX frame's scanned dense bounce, ``rayaccel_tpu/render/whitted.py:
    478-509``)."""
    parts = [trace_fn(Rays(*(a[s:s + scan] for a in rays)), alive[s:s + scan])
             for s in range(0, alive.shape[0], scan)]
    hits = Hits(*(torch.cat(f) for f in zip(*(p[0] for p in parts))))
    surf = SurfaceSample(*(torch.cat(f) for f in zip(*(p[1] for p in parts))))
    return hits, surf, sum(p[2] for p in parts)


def _trace_step(scene, env, st, bk, tile, max_depth, stack_size, shadows,
                primary_only, opts, stack_depth: int = 48,
                scan: int | None = None):
    """One trace on engine ``bk`` and the step after it. With ``scan``, a
    dense engine ("pallas", "mxu") traces a width that is a multiple of
    ``scan`` and wider in slices of ``scan`` lanes."""
    def trace_fn(rays, alive):
        return _trace_and_surface(scene, rays, alive, bk, tile, opts, env,
                                  stack_depth)

    R = st["alive"].shape[0]
    if scan and bk in ("pallas", "mxu") and R > scan and R % scan == 0:
        hits, surf, ov = _trace_scanned(trace_fn, st["rays"], st["alive"],
                                        scan)
    else:
        hits, surf, ov = trace_fn(st["rays"], st["alive"])
    st = dict(st, dropped=st["dropped"] + ov)
    with span("racc.shade"):
        return _whitted_step(scene, st, hits, surf, bk, tile, max_depth,
                             stack_size, shadows, primary_only, opts,
                             stack_depth)


def whitted_trace_wave(scene, env: Environment, cam_arrays,
                       x: torch.Tensor, y: torch.Tensor, alive0: torch.Tensor,
                       key, max_depth: int, stack_size: int = 9,
                       backend: str = "pallas", tile: int = 512,
                       stack_depth: int = 48, shadows: bool = False,
                       bounce_backend: str | None = None,
                       primary_only: bool = False,
                       opts: EngineOpts = EngineOpts()):
    """Trace one wave of pixels through their full Whitted ray trees: the
    primary trace on ``backend``, then bounces on ``bounce_backend`` while
    any lane is alive.

    Returns (radiance (R, 3), traced, dropped).

    The engine defaults to ``backend="pallas"``, the port's kernel path. The
    JAX package's ``whitted_trace_wave`` defaults to "mxu", which in the
    port is the plain ``torch.bmm`` engine, so a call that leaves
    ``backend`` out runs another engine in each package; the renderers
    always pass theirs."""
    if bounce_backend is None:
        bounce_backend = backend
    rays = generate_pixel_rays(cam_arrays, x, y, key=key)
    st = _initial_state(rays, alive0, stack_size)
    bk = backend
    while read_any(st["alive"], "racc.render.read.wave_alive"):
        with span("racc.render.loop"):
            st = _trace_step(scene, env, st, bk, tile, max_depth,
                             stack_size, shadows, primary_only, opts,
                             stack_depth)
            bk = bounce_backend
    return st["radiance"], st["traced"], st["dropped"]


def _reshard_trees(st, mesh: Mesh, D: int):
    """Cross-rank balance of the pooled trees before the bounce loop: the
    shared striped exchange (``parallel/mesh.py:reshard_balance_cols``)
    over 25 columns, o, d, weight, radiance, depth, sp, alive and stack
    level 0 (7 + 3): after the one primary step only level 0 can be
    occupied. Whitted shading is deterministic, so the radiance is bitwise
    the same whether it fires or not. Returns (state, resharded)."""
    r = st["rays"]
    S = torch.cat([r.o, r.d, st["weight"], st["radiance"],
                   st["depth"].to(torch.float32)[:, None],
                   st["sp"].to(torch.float32)[:, None],
                   st["alive"].to(torch.float32)[:, None],
                   st["stk"][0].T, st["stk_w"][0].T], dim=1)
    S, lane, resharded = reshard_balance_cols(S, st["lane"], st["alive"],
                                              mesh, D)
    if not resharded:
        return st, False
    stk = torch.zeros_like(st["stk"])
    stk_w = torch.zeros_like(st["stk_w"])
    stk[0] = S[:, 15:22].T
    stk_w[0] = S[:, 22:25].T
    return dict(st, rays=secondary_rays(S[:, 0:3].contiguous(),
                                        S[:, 3:6].contiguous()),
                weight=S[:, 6:9], radiance=S[:, 9:12],
                depth=S[:, 12].to(torch.int32), sp=S[:, 13].to(torch.int32),
                alive=S[:, 14] > 0, stk=stk, stk_w=stk_w, lane=lane), True


def _stage_widths(N: int, stage_ratio: int, min_stage_width: int):
    """Width ladder of the pooled bounce loop: divide by ``stage_ratio``
    (rounded up to a multiple of 1024) while the result stays at or above
    ``min_stage_width``."""
    widths = [N]
    while widths[-1] // stage_ratio >= min_stage_width:
        widths.append(-(-widths[-1] // stage_ratio // 1024) * 1024)
    return widths


def whitted_trace_frame(scene: ClusterScene, env: Environment, cam_arrays,
                        xs: torch.Tensor, ys: torch.Tensor,
                        alives: torch.Tensor, key, max_depth: int,
                        stack_size: int = 9, backend: str = "pallas",
                        tile: int = 512, shadows: bool = False,
                        bounce_backend: str = "sparse",
                        min_stage_width: int = 8192,
                        opts: EngineOpts = EngineOpts(),
                        stage_ratio: int = 2, hot_levels: int = 3,
                        mesh: Mesh | None = None, n_shards: int = 1,
                        reshard: bool = True, info: dict | None = None,
                        bounce_scan: int | None = None):
    """Trace a whole frame of ray trees with one pooled bounce loop.

    1. Stage 1 traces and first-shades the primaries wave by wave on
       ``backend``, with the jitter drawn from ``fold_in(key, w)``.
    2. Stage 2 pools every lane, its parked stack included, in frame
       order and runs one bounce loop on ``bounce_backend``. When the live
       count fits the next width of the ladder (ratio ``stage_ratio``,
       floor ``min_stage_width``), live lanes move to the head (a stable
       sort), and the lanes left behind emit (lane, radiance) rows as a
       piece at full width, with rows that must not contribute marked
       invalid. Stack levels below ``hot_levels`` always move; the deep
       levels move only when some lane has parked that deep. With
       ``bounce_scan``, a bounce on a dense engine ("pallas", "mxu") over
       a pool wider than ``bounce_scan`` and a multiple of it is traced in
       slices of ``bounce_scan`` lanes, their overflow summed into
       ``dropped``; other bounces are traced whole.
    3. The pieces are reassembled by lane id.

    With ``mesh`` (of ``n_shards`` ranks), ``xs``, ``ys`` and ``alives``
    are this rank's lanes of each wave, the rank is folded into ``key``
    first (only the camera jitter draws: Whitted shading is
    deterministic), and lane ids are global (rank * N + local). With
    ``reshard`` and more than one rank, the pooled trees are balanced
    across the ranks once before the bounce loop (every rank must enter
    it) and their radiance is routed home at reassembly.

    Returns (radiance (W, R, 3) in lane order, traced, dropped): this
    rank's. With ``info``, the numbers of bounce-loop iterations, shrinks
    and shrinks that moved the deep stack levels, and whether the reshard
    fired, are written to it.

    The engine defaults to ``backend="pallas"``, the port's kernel path. The
    JAX package's ``whitted_trace_frame`` defaults to "mxu", which in the
    port is the plain ``torch.bmm`` engine, so a call that leaves
    ``backend`` out runs another engine in each package; the renderers
    always pass theirs."""
    W, R = xs.shape
    N = W * R
    lane0 = first_lane(N, mesh, n_shards)
    S = stack_size
    device = xs.device
    f32 = dict(dtype=torch.float32, device=device)
    if mesh is not None:
        key = rng.fold_in(key, mesh.rank)

    # ---- stage 1: primary trace + first shade/park, wave by wave ----
    # One step from sp = 0 pushes at most once and pops nothing, so only
    # stack level 0 can be occupied: the waves carry a one-level stack
    # (the same parks: 0 < stack_size) and the pool adds the rest.
    with span("racc.render.stage1"):
        with span("racc.render.read.live_waves"):
            live_waves = alives.any(dim=1).tolist()
        waves = []
        for w in range(W):
            with span("racc.render.wave"):
                rays = generate_pixel_rays(cam_arrays, xs[w], ys[w],
                                           key=rng.fold_in(key, w))
                st = _initial_state(rays, alives[w], 1)
                if live_waves[w]:
                    st = _trace_step(scene, env, st, backend, tile,
                                     max_depth, S, shadows, False, opts)
                waves.append(st)

        def pooled(name):
            return torch.cat([wst[name] for wst in waves])

        stk = torch.zeros((S, 7, N), **f32)
        stk_w = torch.zeros((S, 3, N), **f32)
        stk[0] = torch.cat([wst["stk"][0] for wst in waves], dim=1)
        stk_w[0] = torch.cat([wst["stk_w"][0] for wst in waves], dim=1)
        st = dict(
            rays=secondary_rays(
                torch.cat([wst["rays"].o for wst in waves]),
                torch.cat([wst["rays"].d for wst in waves])),
            weight=pooled("weight"), depth=pooled("depth"),
            alive=pooled("alive"), sp=pooled("sp"), stk=stk, stk_w=stk_w,
            radiance=pooled("radiance"),
            lane=torch.arange(lane0, lane0 + N, dtype=torch.int32,
                              device=device),
            traced=sum(wst["traced"] for wst in waves),
            dropped=sum(wst["dropped"] for wst in waves))
        del waves, stk, stk_w
    resharded = False
    if mesh is not None and n_shards > 1 and reshard:
        with span("racc.render.exchange"):
            st, resharded = _reshard_trees(st, mesh, n_shards)

    # ---- stage 2: one bounce loop over the pooled trees ----
    stage_widths = _stage_widths(N, stage_ratio, min_stage_width)
    H = min(hot_levels, S)
    deep_hauls = 0

    def step(st):
        return _trace_step(scene, env, st, bounce_backend, tile, max_depth,
                           S, shadows, False, opts, scan=bounce_scan)

    def narrow(st, perm, n_live):
        nonlocal deep_hauls
        nxt = perm.shape[0]
        # Occupied levels are 0..sp-1: the deep tier moves only when some
        # lane has parked past the hot levels.
        L = S if H < S and read_any(st["sp"] > H,
                                    "racc.render.read.deep_stack") else H
        deep_hauls += L > H
        stk = torch.zeros((S, 7, nxt), **f32)
        stk_w = torch.zeros((S, 3, nxt), **f32)
        stk[:L] = st["stk"][:L, :, perm]
        stk_w[:L] = st["stk_w"][:L, :, perm]
        r = st["rays"]
        return dict(
            rays=secondary_rays(r.o[perm], r.d[perm]),
            weight=st["weight"][perm], radiance=st["radiance"][perm],
            depth=st["depth"][perm], sp=st["sp"][perm],
            alive=torch.arange(nxt, device=device) < n_live,
            stk=stk, stk_w=stk_w, lane=st["lane"][perm],
            traced=st["traced"], dropped=st["dropped"])

    # Live lanes keep their radiance in the head (partial sums never split
    # between pieces).
    st, allp, iterations = run_pool(st, stage_widths, step, narrow,
                                    lambda st: (st["radiance"],))
    if info is not None:
        info.update(iterations=iterations, shrinks=len(stage_widths) - 1,
                    deep_hauls=deep_hauls, resharded=resharded)

    # ---- stage 3: reassembly by lane id ----
    with span("racc.render.assemble"):
        rad = by_lane(allp[:, 0], allp[:, 1:4], N, lane0, mesh, resharded)
    return rad.reshape(W, R, 3), st["traced"], st["dropped"]


class WhittedRenderer(TiledRenderer):
    """Whitted ray tracer over a compiled scene (``TiledRenderer._setup``:
    the engines, under ``hybrid_tracing`` the dense engines' bounces on the
    sparse pair engine); the primaries' shadow rays go to the primary
    engine. The frame runs on the pooled tree loop
    (``whitted_trace_frame``) when the configuration regroups on a cluster
    engine and the trees bounce; ``primary_only``, ``regroup=False`` and
    the "xla" engine trace wave by wave (``whitted_trace_wave``).

    ``tpu_scene`` may be a ClusterScene or a TpuScene; without one the
    scene is compiled for the backend. Under a mesh every rank traces rank
    0's scene and environment and its own lanes of each wave; the pooled
    frame balances the ranks' trees when ``reshard_bounces`` is set."""

    def __init__(self, context: Context, camera: Camera, scene_data: SceneData,
                 tpu_scene=None, environment: Environment | None = None,
                 shadows: bool = False, primary_only: bool = False):
        super().__init__(context, scene_data.viewport_width,
                         scene_data.viewport_height)
        cfg = context.configuration
        self.shadows = shadows
        self.primary_only = primary_only
        self._setup(camera, scene_data, tpu_scene, environment)
        # main.cpp:346 forces maxDepth=8 for the Whitted demo.
        self.stack_size = max(cfg.max_shading_depth, self.max_depth + 1)
        self.stage_ratio = cfg.whitted_stage_ratio
        self.hot_levels = cfg.whitted_hot_levels
        self.bounce_scan = cfg.whitted_bounce_scan
        self.pooled = self.pooled and not primary_only
        self.last_info: dict = {}

    def _wave_kwargs(self):
        return dict(stack_size=self.stack_size, backend=self.backend,
                    tile=self.tile, shadows=self.shadows,
                    bounce_backend=self.bounce_backend, opts=self.opts)

    def _render(self, key):
        if not self.pooled:
            return super()._render(key)
        return whitted_trace_frame(
            self.scene, self.environment, self._camera_arrays(),
            self._wave_x, self._wave_y, self._wave_alive, key, self.max_depth,
            min_stage_width=self.min_stage_width,
            stage_ratio=self.stage_ratio, hot_levels=self.hot_levels,
            bounce_scan=self.bounce_scan, info=self.last_info,
            **self._mesh_kwargs(), **self._wave_kwargs())

    def _trace_wave(self, x, y, alive, wave_key):
        return whitted_trace_wave(
            self.scene, self.environment, self._camera_arrays(),
            x, y, alive, wave_key, self.max_depth,
            stack_depth=self.stack_depth, primary_only=self.primary_only,
            **self._wave_kwargs())
