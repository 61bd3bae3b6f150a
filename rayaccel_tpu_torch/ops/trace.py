"""Lockstep wavefront BVH traversal, and the engine dispatcher.

Counterpart of ``rayaccel_tpu/ops/trace.py``: ``trace_bvh``,
``trace_occlusion_bvh`` and ``trace``. Every ray of the wave runs the same
state machine in lockstep; per iteration each lane is either

  - at an interior node (``cur >= 0``): fetch the 2-wide node row, slab-test
    both children, descend near-first and push the far child, or
  - inside a leaf (``cur < 0``): intersect one TrianglePair and advance the
    encoded (first, count) cursor, or
  - popping / done.

The JAX functions are compiled ``while_loop``s with (depth, R) stacks
blended by one-hot masks; here the loop runs eagerly in plain tensor
arithmetic, the stacks are (R, depth) and a push or pop is one
``gather`` / ``scatter_`` at the lane's level. A step of a lane that is DONE
changes nothing, so the loop reads ``any(cur != DONE)`` on the host only
every ``_CHECK_EVERY`` iterations. A lane that pushes past ``stack_depth``
overwrites its top level (the JAX function drops such a push); neither is
correct, and neither happens at the default depth.
"""

from __future__ import annotations

import torch

from rayaccel_tpu_torch.environment import Environment, sample_environment
from rayaccel_tpu_torch.ops.bruteforce import trace_bruteforce
from rayaccel_tpu_torch.ops.intersect import (aabb_hit_soa,
                                              rotate_barycentrics,
                                              safe_inv_dir,
                                              triangle_pair_intersect_soa)
from rayaccel_tpu_torch.ops.trace_dense import trace_dense
from rayaccel_tpu_torch.ops.trace_mxu import trace_mxu
from rayaccel_tpu_torch.ops.trace_sparse import trace_sparse
from rayaccel_tpu_torch.scene.compile import TpuScene
from rayaccel_tpu_torch.types import Hits, INVALID_TRIANGLE, Rays

DONE = 0x7FFFFFFF
POP = 0x7FFFFFFE
_LEAF_MASK = 0xFFFFFF
_CHECK_EVERY = 8


def _setup(rays: Rays, active):
    """Per-component lane vectors and the start cursor."""
    R = rays.o.shape[0]
    o = tuple(rays.o[:, a] for a in range(3))
    inv3 = safe_inv_dir(rays.d)
    d = tuple(rays.d[:, a] for a in range(3))
    inv_d = tuple(inv3[:, a] for a in range(3))
    ood = tuple(-o[a] * inv_d[a] for a in range(3))
    cur = torch.zeros((R,), dtype=torch.int32, device=rays.o.device)
    if active is not None:
        cur = torch.where(active, cur, DONE)          # start at root node 0
    return o, d, inv_d, ood, cur


def _node_step(scene: TpuScene, cur, inv_d, ood, tmin, tmax):
    """Fetch each lane's node row and slab-test both children. Returns
    (is_node, c0, c1, hit0, t0, hit1, t1)."""
    is_node = (cur >= 0) & (cur != DONE) & (cur != POP)
    row = scene.nodes[torch.where(is_node, cur, 0).long()]     # (R, 16)
    refs = row[:, 12:14].contiguous().view(torch.int32)
    hit0, t0 = aabb_hit_soa((row[:, 0], row[:, 1], row[:, 2]),
                            (row[:, 3], row[:, 4], row[:, 5]),
                            inv_d, ood, tmin, tmax)
    hit1, t1 = aabb_hit_soa((row[:, 6], row[:, 7], row[:, 8]),
                            (row[:, 9], row[:, 10], row[:, 11]),
                            inv_d, ood, tmin, tmax)
    return is_node, refs[:, 0], refs[:, 1], hit0, t0, hit1, t1


def _leaf_step(scene: TpuScene, cur, o, d, tmin, tmax):
    """Intersect each leaf lane's current TrianglePair. Returns (is_leaf,
    first, count, pair hit)."""
    is_leaf = cur < 0
    enc = torch.where(is_leaf, -cur - 1, 0)
    first = enc & _LEAF_MASK
    count = enc >> 24                 # enc >= 0: the shift is logical
    prow = scene.pairs[first.long()]                           # (R, 16)
    ph = triangle_pair_intersect_soa(
        tuple(prow[:, k] for k in range(12)), o, d, tmin, tmax)
    return is_leaf, first, count, ph


def _leaf_next(first, count):
    """The cursor after one pair: addition, not OR (if first + 1 carried
    into bit 24 an OR would corrupt the count field)."""
    count2 = count - 1
    return torch.where(count2 > 0, -((first + 1) + (count2 << 24)) - 1, POP)


def _push(stack, sp, push, value):
    top = stack.shape[1] - 1
    level = torch.clamp_max(sp, top).long()[:, None]
    stack.scatter_(1, level, torch.where(push[:, None], value[:, None],
                                         stack.gather(1, level)))
    return sp + push.to(torch.int32)


def _pop(stack, sp, nxt):
    """Resolve POP cursors from the stack; an empty stack means DONE."""
    need_pop = nxt == POP
    can_pop = need_pop & (sp > 0)
    sp = sp - can_pop.to(torch.int32)
    top = stack.shape[1] - 1
    popped = stack.gather(1, torch.clamp(sp, 0, top).long()[:, None])[:, 0]
    nxt = torch.where(need_pop, torch.where(can_pop, popped, DONE), nxt)
    return sp, nxt


def _running(cur, it: int) -> bool:
    return it % _CHECK_EVERY != 0 or bool((cur != DONE).any())


def trace_bvh(scene: TpuScene, rays: Rays, env: Environment | None = None,
              stack_depth: int = 48,
              active: torch.Tensor | None = None) -> Hits:
    """Trace a wave of rays through the compiled scene.

    Returns closest hits with barycentrics un-rotated to the original
    triangle vertex order, and environment radiance in ``miss_rgb`` where
    no triangle was hit. Lanes where ``active`` is False are skipped
    (reported as misses with zero radiance)."""
    R = rays.o.shape[0]
    dev = rays.o.device
    o, d, inv_d, ood, cur = _setup(rays, active)
    sp = torch.zeros((R,), dtype=torch.int32, device=dev)
    stack = torch.zeros((R, stack_depth), dtype=torch.int32, device=dev)
    t_cur = rays.tmax.clone()
    best = torch.full((R,), -1, dtype=torch.int32, device=dev)  # slot 2p+w
    bu = torch.zeros((R,), dtype=torch.float32, device=dev)
    bv = torch.zeros((R,), dtype=torch.float32, device=dev)

    it = 0
    while _running(cur, it):
        it += 1
        is_node, c0, c1, hit0, t0, hit1, t1 = _node_step(
            scene, cur, inv_d, ood, rays.tmin, t_cur)
        both = hit0 & hit1
        near_is_1 = t1 < t0
        near = torch.where(near_is_1, c1, c0)
        far = torch.where(near_is_1, c0, c1)
        node_next = torch.where(
            both, near, torch.where(hit0, c0, torch.where(hit1, c1, POP)))
        sp = _push(stack, sp, is_node & both, far)

        is_leaf, first, count, ph = _leaf_step(scene, cur, o, d, rays.tmin,
                                               t_cur)
        hit_ok = is_leaf & (count > 0) & ph.valid
        best = torch.where(hit_ok, first * 2 + ph.which, best)
        bu = torch.where(hit_ok, ph.u, bu)
        bv = torch.where(hit_ok, ph.v, bv)
        t_cur = torch.where(hit_ok, ph.t, t_cur)

        nxt = torch.where(is_node, node_next,
                          torch.where(is_leaf, _leaf_next(first, count),
                                      DONE))
        sp, cur = _pop(stack, sp, nxt)

    hit = best >= 0
    # Bits 30-31 of a remap word are the rotation code: widen before the
    # shift so that it is logical.
    remap = scene.pair_tri[torch.where(hit, best, 0).long()].to(
        torch.int64) & 0xFFFFFFFF
    tri = (remap & 0x3FFFFFFF).to(torch.int32)
    code = (remap >> 30).to(torch.int32)
    u, v = rotate_barycentrics(code, bu, bv)

    if env is not None:
        mask = hit if active is None else (hit | ~active)
        miss_rgb = torch.where(mask[:, None], 0.0,
                               sample_environment(env, rays.d))
    else:
        miss_rgb = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    return Hits(tri=torch.where(hit, tri, INVALID_TRIANGLE),
                t=torch.where(hit, t_cur, rays.tmax),
                u=torch.where(hit, u, 0.0), v=torch.where(hit, v, 0.0),
                miss_rgb=miss_rgb)


def trace_occlusion_bvh(scene: TpuScene, rays: Rays,
                        active: torch.Tensor | None = None,
                        stack_depth: int = 48) -> torch.Tensor:
    """Any-hit (occlusion/shadow) query on the lockstep BVH engine: True
    where some triangle blocks the ray within [tmin, tmax]. A lane whose
    pair test hits anything retires at once."""
    R = rays.o.shape[0]
    dev = rays.o.device
    o, d, inv_d, ood, cur = _setup(rays, active)
    sp = torch.zeros((R,), dtype=torch.int32, device=dev)
    stack = torch.zeros((R, stack_depth), dtype=torch.int32, device=dev)
    occluded = torch.zeros((R,), dtype=torch.bool, device=dev)

    it = 0
    while _running(cur, it):
        it += 1
        is_node, c0, c1, hit0, _, hit1, _ = _node_step(
            scene, cur, inv_d, ood, rays.tmin, rays.tmax)
        # Any-hit: no near/far ordering, descend child 0 first and push 1.
        node_next = torch.where(hit0, c0, torch.where(hit1, c1, POP))
        sp = _push(stack, sp, is_node & hit0 & hit1, c1)

        is_leaf, first, count, ph = _leaf_step(scene, cur, o, d, rays.tmin,
                                               rays.tmax)
        hit_ok = is_leaf & (count > 0) & ph.valid
        occluded = occluded | hit_ok
        leaf_next = torch.where(hit_ok, DONE, _leaf_next(first, count))
        nxt = torch.where(is_node, node_next,
                          torch.where(is_leaf, leaf_next, DONE))
        sp, cur = _pop(stack, sp, nxt)
    return occluded


def trace(scene, rays: Rays, env: Environment | None = None,
          backend: str = "xla", stack_depth: int = 48) -> Hits:
    """Engine dispatcher. ``scene`` is a TpuScene for the xla / bruteforce
    engines or a ClusterScene for mxu / pallas / sparse."""
    if backend == "xla":
        return trace_bvh(scene, rays, env, stack_depth=stack_depth)
    if backend == "mxu":
        return trace_mxu(scene, rays, env).hits
    if backend == "pallas":
        return trace_dense(scene, rays, env)[0].hits
    if backend == "sparse":
        return trace_sparse(scene, rays, env)[0].hits
    if backend == "bruteforce":
        hits = trace_bruteforce(scene.tri_verts, rays)
        if env is not None:
            miss = hits.tri == INVALID_TRIANGLE
            hits = hits._replace(miss_rgb=torch.where(
                miss[:, None], sample_environment(env, rays.d), 0.0))
        return hits
    raise ValueError(f"unknown backend {backend!r}")
