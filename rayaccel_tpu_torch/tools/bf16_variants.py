"""Time the bf16 tensor-core variants of K1 and K4 under other choices of
their compile-time shape, on one CUDA device.

    python3 -m rayaccel_tpu_torch.tools.bf16_variants

Run from the root of a checkout. For each variant the package is copied
under the git-ignored ``rayaccel_tpu_torch/_build/variants/``, one constant
of ``csrc/`` is rewritten, and a subprocess builds that copy's kernels and
times them on ``chip_smoke.py``'s headline inputs (the 65,536-ray primary
wave of the battlefield-like scene at 1280x720 for K1, the shadow rays of
its hits for K4): CUDA-event ms (``chip_smoke.py:cuda_ms``), the pairs the
warps walked, and the words (K1) or flags (K4) differing from the plain
versions walking in the variant's group. Prints one JSON line a variant;
the first, ``chosen``, is the tree as it is.
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
    from rayaccel_tpu_torch.render import pathtracer, whitted
    from rayaccel_tpu_torch.render.shading import surface_from_attrs
    from rayaccel_tpu_torch.scene.clusters import (cluster_scene_from_numpy,
                                                   compile_clusters_np)
    from rayaccel_tpu_torch.scene.loader import make_battlefield_like
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
    slot = dense.dense_closest_hit(*a1)[1]
    hit = slot >= 0
    attr, tri, t, u, v = dense.reconstruct(cs, rays, torch.where(hit, slot, 0))
    surf = surface_from_attrs(attr, cs.mat_params, rays,
                              dense.make_hits(rays, hit, tri, t, u, v))
    F4, *q4 = dense._dense_inputs(cs, whitted.shadow_rays(surf),
                                  active & hit, tile, opts.k_step,
                                  opts.tile_cap)
    a4 = (F4, cs.G3, q4[0], q4[1], q4[2], tile)
    kw = dict(precision="default", G3b=cs.G3b)
    plain = dict(precision="default", group=warp_rays)
    line = dict(variant=name, warp_rays=warp_rays,
                device=torch.cuda.get_device_name(0))
    for key, fn, fn_plain, a in (
            ("k1", dense.dense_closest_hit, dense.dense_closest_hit_plain,
             a1),
            ("k4", dense.dense_occluded, dense.dense_occluded_plain, a4)):
        got, want = fn(*a, **kw), fn_plain(*a, **plain)
        line[key] = dict(ms=smoke.cuda_ms(lambda: fn(*a, **kw), 20),
                         pairs_walked=smoke.counted(fn, a, "walked", 1,
                                                    **kw)[0],
                         differing=int((got != want).sum()))
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
