"""Cross-engine agreement oracle: counterpart of ``tools/oracle_lib.py``.

The reference's own oracle is its backend flag matrix: the same frame must
agree with any engine turned off. Here the cluster engines trace the same
rays on the caller's device and are scored against the plain ``mxu``
engine, and a whole frame of the production path is scored against the
lockstep-BVH ``xla`` engine. Engine map (the reference's name: closest
hit, occlusion):

- ``mxu``: ``ops/trace_mxu.py:trace_mxu``, ``trace_occlusion_mxu``;
- ``pallas``: ``ops/trace_dense.py:trace_dense``,
  ``trace_occlusion_dense``;
- ``sparse``: ``ops/trace_sparse.py:trace_sparse``,
  ``trace_occlusion_sparse``.

The dense occlusion row carries the queue clamp's overflow count, which
the JAX row writes as 0 (``trace_occlusion_pallas`` discards it).

:func:`run_oracle` is :func:`ray_sets` scored by :func:`compare_set` and
held to :func:`oracle_bar`; a caller that reads something between the sets
(launch counts) runs the two itself.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.camera import Camera, generate_pixel_rays
from rayaccel_tpu_torch.config import EngineOpts
from rayaccel_tpu_torch.environment import create_environment
from rayaccel_tpu_torch.ops.trace_dense import (trace_dense,
                                                trace_occlusion_dense)
from rayaccel_tpu_torch.ops.trace_mxu import trace_mxu, trace_occlusion_mxu
from rayaccel_tpu_torch.ops.trace_sparse import (trace_occlusion_sparse,
                                                 trace_sparse)
from rayaccel_tpu_torch.render.pathtracer import pt_trace_frame
from rayaccel_tpu_torch.render.tiled import BLOCK_H, BLOCK_W, block_swizzle
from rayaccel_tpu_torch.scene.compile import compile_scene
from rayaccel_tpu_torch.types import Rays

# A row passes when more than this share of its rays agree on hit and on
# t within 1e-3 relative.
BAR = 0.9995
# The sparse engine's exactness budget (``tools/oracle_lib.py:31-39``):
# mid-frame primaries carry ~3.1 lattice pairs a ray, beyond the default
# pair_budget of 3, and long camera rays need more restarts than 4.
SPARSE_BUDGET = dict(max_passes=16, pair_budget=4)


def _trace(bk, cs, rays, tile):
    """(tri, t, overflow) of engine ``bk``'s closest hits, on the host."""
    if bk == "mxu":
        res, ov = trace_mxu(cs, rays, tile=tile), 0
    elif bk == "pallas":
        res, ov = trace_dense(cs, rays, tile=tile)
    else:
        res, ov = trace_sparse(cs, rays, **SPARSE_BUDGET)
    return res.hits.tri.cpu().numpy(), res.hits.t.cpu().numpy(), int(ov)


def _occluded(bk, cs, rays, tile):
    """(flags, overflow) of engine ``bk``'s any-hit query, on the host."""
    if bk == "pallas":
        occ, ov = trace_occlusion_dense(cs, rays, tile=tile)
    else:
        occ, ov = trace_occlusion_sparse(cs, rays, **SPARSE_BUDGET)
    return occ.cpu().numpy(), int(ov)


def ray_sets(cs, sd, n_rays=65536, key=None):
    """Yield (name, rays, engines) for the reference's three ray sets, on
    ``cs``'s device: ``primary`` (block-swizzled camera rays from the
    middle of the frame), ``scattered`` (origins uniform in the scene box,
    directions uniform on the sphere) and ``sky`` (straight up from above
    the scene: no candidate pair at all)."""
    key = rng.PRNGKey(42) if key is None else key
    dev = cs.G3.device
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                         sd.viewport_width, sd.viewport_height).as_arrays(dev)
    # The swizzle's first waves are the top of the screen, sky on the
    # battlefield camera; the middle of the frame looks at geometry.
    _, x, y = block_swizzle(sd.viewport_width, sd.viewport_height,
                            max(n_rays, 983040))
    base = (x.shape[0] - n_rays) // 2

    def lanes(a):
        return torch.as_tensor(a[base:base + n_rays], dtype=torch.int32,
                               device=dev)

    yield "primary", generate_pixel_rays(cam, lanes(x), lanes(y),
                                         key=rng.fold_in(key, 0)), \
        ("pallas", "sparse")
    lo = cs.cl_bbmin.amin(dim=0)
    hi = cs.cl_bbmax.amax(dim=0)
    k1, k2 = rng.split(rng.fold_in(key, 1))
    o = rng.uniform(k1, (n_rays, 3), dev) * (hi - lo) + lo
    d = rng.normal(k2, (n_rays, 3), dev)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)

    def window(o, d):
        return Rays(o, d, torch.full((n_rays,), 1e-3, device=dev),
                    torch.full((n_rays,), 1e6, device=dev))

    yield "scattered", window(o, d), ("sparse",)
    up = torch.tensor([[0.0, 1.0, 0.0]], device=dev).expand(n_rays, 3)
    yield "sky", window(up * (hi[None, :] + 10.0), up.contiguous()), \
        ("pallas", "sparse")


def compare_set(cs, name, rays, engines, tile=1024):
    """The rows of one ray set: each engine's closest hits, then its
    any-hit flags, against the ``mxu`` engine's."""
    rows = []
    ref_tri, ref_t, _ = _trace("mxu", cs, rays, tile)
    for bk in engines:
        tri, t, ov = _trace(bk, cs, rays, tile)
        hit_ref = ref_tri >= 0
        hit_bk = tri >= 0
        both = hit_ref & hit_bk
        # Near ties: engines may pick either of two coplanar or
        # shared-edge winners; t must still agree.
        rel = np.abs(t[both] - ref_t[both]) / np.maximum(ref_t[both], 1e-6)
        rows.append(dict(
            rays=name, engine=f"{bk} vs mxu",
            hit_agree=round(float((hit_ref == hit_bk).mean()), 6),
            tri_agree=round(float((tri[both] == ref_tri[both]).mean())
                            if both.any() else 1.0, 6),
            t_within_1e3=round(float((rel < 1e-3).mean())
                               if both.any() else 1.0, 6),
            overflow=ov, n=int(ref_tri.size)))
    occ_ref = trace_occlusion_mxu(cs, rays, tile=tile).cpu().numpy()
    for bk in engines:
        occ, ov = _occluded(bk, cs, rays, tile)
        rows.append(dict(rays=name, engine=f"occl:{bk} vs mxu",
                         hit_agree=round(float((occ == occ_ref).mean()), 6),
                         tri_agree=1.0, t_within_1e3=1.0, overflow=ov,
                         n=int(occ_ref.size)))
    return rows


def oracle_bar(rows) -> bool:
    """The reference's bar: every row above :data:`BAR` on hit agreement
    and on t within 1e-3."""
    return all(r["hit_agree"] > BAR and r["t_within_1e3"] > BAR
               for r in rows)


def run_oracle(cs, sd, n_rays=65536, tile=1024, key=None):
    """Trace the three ray sets on every engine of each and score them
    against ``mxu``. Returns (rows, ok), as ``tools/oracle_lib.py``."""
    rows = []
    for name, rays, engines in ray_sets(cs, sd, n_rays, key):
        rows += compare_set(cs, name, rays, engines, tile)
    return rows, oracle_bar(rows)


def require_oracle_bar(name, s):
    """Raise unless one agreement record (``hit_agree``, ``t_within_1e3``)
    reaches :data:`BAR`."""
    if not (s["hit_agree"] >= BAR and s["t_within_1e3"] >= BAR):
        raise AssertionError(f"{name} fails the oracle bar: {s}")


def two_class_gate(img, ref):
    """``run_image_oracle``'s two-class gate on (n, 3) pixels. A pixel that
    differs by more than 0.05 in some channel is a winner flip (one
    shared-edge flip re-aims every later segment of its path); the rest of
    the image must meet ``rmse_trimmed < 1e-3`` and the flips
    ``frac_flip < 0.005``. ``image_rmse`` is reported, not gated."""
    diff = img - ref
    pix = np.abs(diff).max(axis=1)
    flip = pix > 0.05
    trim = diff[~flip]
    return dict(rmse_trimmed=float(np.sqrt(np.mean(trim * trim))),
                frac_flip=float(flip.mean()),
                image_rmse=float(np.sqrt(np.mean(diff * diff))),
                max_abs=float(pix.max()),
                frac_gt_1e3=float((pix > 1e-3).mean()),
                n_pixels=int(len(pix)))


def run_image_oracle(cs, sd, n_spp=2, viewport=(320, 180), max_depth=2,
                     opts=None, key=None):
    """Whole-image agreement at a small viewport: the production pooled
    path (dense primaries, sparse bounces, tile 1024, on ``cs``) against
    the ``xla`` engine (lockstep BVH on a ``TpuScene`` from
    ``compile_scene``), both through ``pt_trace_frame`` with the same keys
    on ``cs``'s device, so the images differ only where the engines do.
    Returns the reference's dict (the gate's numbers rounded as there),
    ``dropped``, the two sides' overflow summed, and ``prod_seconds`` and
    ``ref_seconds``, the host time of each side's frames."""
    key = rng.PRNGKey(7) if key is None else key
    opts = EngineOpts() if opts is None else opts
    dev = cs.G3.device
    w, h = viewport
    sd_small = type(sd)(**{**sd.__dict__, "viewport_width": w,
                           "viewport_height": h, "max_depth": max_depth})
    bvh_scene = compile_scene(sd_small, device=dev)
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                         w, h).as_arrays(dev)
    N = (-(-w // BLOCK_W)) * (-(-h // BLOCK_H)) * BLOCK_W * BLOCK_H
    perm, x, y = block_swizzle(w, h, N)
    xs = torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(1, N)
    ys = torch.as_tensor(y, dtype=torch.int32, device=dev).reshape(1, N)
    alives = torch.as_tensor(perm >= 0, device=dev).reshape(1, N)
    px = sd_small.env_pixels
    env = create_environment(px, px.shape[1], px.shape[0], device=dev)

    def render(scene, backend, bounce_backend):
        t0 = time.perf_counter()
        fb = torch.zeros((1, N, 3), dtype=torch.float32, device=dev)
        dropped = 0
        for i in range(n_spp):
            rad, _, d = pt_trace_frame(
                scene, env, cam, xs, ys, alives, rng.fold_in(key, i),
                max_depth, backend=backend, tile=1024,
                bounce_backend=bounce_backend, opts=opts)
            fb = fb + rad
            dropped += int(d)
        return (fb[0].cpu().numpy() / n_spp, dropped,
                time.perf_counter() - t0)

    img_prod, dropped_prod, prod_s = render(cs, "pallas", "sparse")
    img_ref, dropped_ref, ref_s = render(bvh_scene, "xla", "xla")
    valid = perm >= 0
    gate = two_class_gate(img_prod[valid], img_ref[valid])
    return dict(image_rmse=round(gate["image_rmse"], 8),
                rmse_trimmed=round(gate["rmse_trimmed"], 8),
                frac_flip=round(gate["frac_flip"], 6),
                max_abs=round(gate["max_abs"], 6),
                frac_gt_1e3=round(gate["frac_gt_1e3"], 6),
                n_pixels=gate["n_pixels"], spp=n_spp, viewport=[w, h],
                depth=max_depth, dropped=dropped_prod + dropped_ref,
                prod_seconds=prod_s, ref_seconds=ref_s)
