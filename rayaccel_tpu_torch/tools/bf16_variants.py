"""Time the bf16 tensor-core variants of K1, K3 and K4 under other choices
of their compile-time shape, on one CUDA device.

    python3 -m rayaccel_tpu_torch.tools.bf16_variants

Run from the root of a checkout. For each variant the package is copied
under the git-ignored ``rayaccel_tpu_torch/_build/variants/``, one constant
of ``csrc/`` is rewritten, and a subprocess builds that copy's kernels and
times them on ``chip_smoke.py``'s headline inputs (the 65,536-ray primary
wave of the battlefield-like scene at 1280x720 for K1, the shadow rays of
its hits for K4, the pairs of pass 1 of the first bounce for K3):
CUDA-event ms (``utils/profiling.py:cuda_ms``), the pairs the warps walked (K1,
K4) or the work units (K3), and the words (K1, K3) or flags (K4)
differing from the plain versions (K1's and K4's walking in the
variant's group). Prints one JSON line a variant; the first, ``chosen``,
is the tree as it is, and adds fp32 K3's ms in the same process.
"""

import json
import os
import re
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)

# name: (source under csrc/, constant, value)
VARIANTS = {
    "chosen": None,
    "warp_rays_32": ("common.cuh", "kFragRays", 32),
    "hit_groups_4": ("dense_hit.cu", "kHitGroups", 4),
    "hit_groups_16": ("dense_hit.cu", "kHitGroups", 16),
    "occl_groups_8": ("dense_occl.cu", "kOcclGroups", 8),
    "occl_groups_32": ("dense_occl.cu", "kOcclGroups", 32),
    "pair_groups_2": ("pair_hit.cu", "kPairGroups", 2),
    "pair_groups_8": ("pair_hit.cu", "kPairGroups", 8),
    "pair_groups_16": ("pair_hit.cu", "kPairGroups", 16),
}


def _copy(name, edit):
    """The package copied with ``edit`` applied; returns the copy's root."""
    root = os.path.join(_PKG, "_build", "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, os.path.join(root, "rayaccel_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    # The native BVH build reads the JAX package's C++ source beside it.
    os.symlink(os.path.join(_ROOT, "rayaccel_tpu"),
               os.path.join(root, "rayaccel_tpu"))
    source, const, value = edit
    path = os.path.join(root, "rayaccel_tpu_torch", "csrc", source)
    text = open(path).read()
    text, n = re.subn(rf"constexpr int {const} = \d+;",
                      f"constexpr int {const} = {value};", text)
    if n != 1:
        raise RuntimeError(f"{const} not found once in {source}")
    open(path, "w").write(text)
    return root


def measure(name, warp_rays):
    """Times the package on sys.path (a copy, or the tree) and prints its
    line."""
    import torch
    import chip_smoke as smoke
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.ops import trace_dense as dense
    from rayaccel_tpu_torch.ops import trace_sparse as sparse
    from rayaccel_tpu_torch.ops.intersect import safe_inv_dir
    from rayaccel_tpu_torch.render import pathtracer, whitted
    from rayaccel_tpu_torch.render.shading import surface_from_attrs
    from rayaccel_tpu_torch.scene.clusters import (cluster_scene_from_numpy,
                                                   compile_clusters_np)
    from rayaccel_tpu_torch.scene.loader import make_battlefield_like
    from rayaccel_tpu_torch.utils import profiling
    dev = torch.device("cuda", 0)
    sd = make_battlefield_like(max_depth=2)
    cs = cluster_scene_from_numpy(**compile_clusters_np(sd), device=dev)
    ctx = racc.create_context(racc.default_configuration(), device=dev)
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, sd.viewport_width,
                              sd.viewport_height)
    r = racc.PathTracingRenderer(ctx, cam, sd, tpu_scene=cs)
    opts, tile, w = ctx.configuration.engine_opts(), r.tile, r.n_waves // 2
    rays = pathtracer._primary_rays(cam.as_arrays(dev), r._wave_x[w],
                                    r._wave_y[w],
                                    rng.fold_in(rng.PRNGKey(1), w))
    active = r._wave_alive[w]
    F, *q = dense._dense_inputs(cs, rays, active, tile, opts.k_step,
                                opts.tile_cap)
    a1 = (F, cs.G3, q[0], q[1], q[2], tile)
    bb = dense.cluster_boxes(cs)
    slot = dense.dense_closest_hit(*a1, boxes=bb)[1]
    hit = slot >= 0
    attr, tri, t, u, v = dense.reconstruct(cs, rays, torch.where(hit, slot, 0))
    surf = surface_from_attrs(attr, cs.mat_params, rays,
                              dense.make_hits(rays, hit, tri, t, u, v))
    F4, *q4 = dense._dense_inputs(cs, whitted.shadow_rays(surf),
                                  active & hit, tile, opts.k_step,
                                  opts.tile_cap)
    a4 = (F4, cs.G3, q4[0], q4[1], q4[2], tile)
    kw = dict(precision="default", G3b=cs.G3b, boxes=bb)
    plain = dict(precision="default", group=warp_rays, boxes=bb)
    line = dict(variant=name, warp_rays=warp_rays,
                device=torch.cuda.get_device_name(0))
    for key, fn, fn_plain, a in (
            ("k1", dense.dense_closest_hit, dense.dense_closest_hit_plain,
             a1),
            ("k4", dense.dense_occluded, dense.dense_occluded_plain, a4)):
        got, want = fn(*a, **kw), fn_plain(*a, **plain)
        line[key] = dict(ms=profiling.cuda_ms(lambda: fn(*a, **kw), 20),
                         pairs_walked=smoke.counted(fn, a, "walked", 2,
                                                    **kw)[0],
                         differing=int((got != want).sum()))
    # K3: pass 1 of the first bounce of the frame's 983,040-lane pool.
    state, _ = pathtracer._stage1(cs, cam.as_arrays(dev), r._wave_x,
                                  r._wave_y, r._wave_alive, rng.PRNGKey(1),
                                  2, "pallas", tile, opts)
    pool = state["rays"]
    tmax = torch.where(state["alive"], pool.tmax,
                       torch.full_like(pool.tmax, -1))
    lat_valid, lat_id, _ = sparse._select(
        cs, pool.o, safe_inv_dir(pool.d), pool.tmin, tmax, opts.k_pairs)
    N, SP = tmax.shape[0], opts.sp_tile
    cap = min(max(SP, -(-opts.pair_budget * N // SP) * SP),
              -(-opts.k_pairs * N // SP) * SP)
    cl, ray, rank, _ = sparse._lattice_pairs(lat_valid, lat_id, cap)
    Fp, items = sparse._pair_inputs(pool.o, pool.d, pool.tmin, tmax, cl, ray,
                                    rank, SP)
    a3 = (Fp, cs.G3, items, max((cs.cluster_size - 1).bit_length(), 1),
          False)
    got = sparse.pair_hit(*a3, **kw)
    want = sparse.pair_hit_plain(*a3, precision="default")
    line["k3"] = dict(ms=profiling.cuda_ms(lambda: sparse.pair_hit(*a3, **kw),
                                       20),
                      units=smoke.counted(sparse.pair_hit, a3, "stats", 3,
                                          **kw)[0],
                      differing=int((got != want).sum()))
    if name == "chosen":
        line["k3_fp32_ms"] = profiling.cuda_ms(lambda: sparse.pair_hit(*a3), 20)
    print(json.dumps(line), flush=True)


def main():
    if sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2], int(sys.argv[3]))
        return 0
    from rayaccel_tpu_torch.ops.trace_dense import BF16_WARP_RAYS
    status = 0
    for name, edit in VARIANTS.items():
        root = _ROOT if edit is None else _copy(name, edit)
        warp_rays = (edit[2] if edit and edit[1] == "kFragRays"
                     else BF16_WARP_RAYS)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, _ROOT]))
        proc = subprocess.run(
            [sys.executable, "-m", "rayaccel_tpu_torch.tools.bf16_variants",
             "--measure", name, str(warp_rays)], cwd=root, env=env,
            timeout=600)
        status = status or proc.returncode
    return status


if __name__ == "__main__":
    sys.exit(main())
