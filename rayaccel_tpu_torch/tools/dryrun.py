"""One frame step of the pooled path tracer, and a multi-rank dry run on
the CPU: counterpart of ``__graft_entry__.py``.

    python -m rayaccel_tpu_torch.tools.dryrun [n_ranks]    # default 8

- :func:`entry` returns ``(fn, example_args)``: one pooled PT frame step
  (``pt_trace_frame`` on the ``mxu`` engine, tile 512, depth 2) of the
  64x64 test scene compiled at ``cluster_size=32``, two waves of 2,048
  lanes, key ``PRNGKey(0)``; on the current CUDA device unless the caller
  passes ``device="cpu"``.
- :func:`dryrun_multichip` runs ``n`` gloo ranks on the CPU, one spawned
  process each, on the same scene: the sharded PT frame with the
  cross-rank reshard (half the lanes dead, so the exchange fires), the
  pooled Whitted tree loop under the same imbalance, and the per-wave PT
  path; each sums ``traced`` over the ranks and checks shapes, finiteness
  and ``traced >= alive``. Four chained PT steps then give
  ``MULTICHIP_MRAYS=<x>``; ``MULTICHIP_DROPPED=<n>`` sums the three steps'
  ``dropped`` over the ranks; the last line is ``dryrun_multichip OK: <n>
  devices, <traced> rays traced, radiance <shape>``.

The JAX function forces a virtual CPU mesh, so this is a CPU smoke by
design, whatever the machine holds: the benchmark reports it as
``multichip_cpu_mesh_smoke``. The card's one-rank mesh is the benchmark's
config 5b. Rank r traces the lanes that ``P(None, "tiles")`` gives JAX's
shard r, with key ``split(PRNGKey(0), n)[r]``, as ``shard_map`` hands it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.camera import Camera
from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.environment import create_environment
from rayaccel_tpu_torch.render.pathtracer import pt_trace_frame, pt_trace_wave
from rayaccel_tpu_torch.render.tiled import block_swizzle
from rayaccel_tpu_torch.render.whitted import whitted_trace_frame
from rayaccel_tpu_torch.scene.clusters import (cluster_scene_from_numpy,
                                               compile_clusters_np)
from rayaccel_tpu_torch.scene.loader import make_test_scene

VIEWPORT = 64
N_LANES = 4096
WAVES = 2
# Seconds a collective may wait for the other ranks, and the whole run.
RANK_TIMEOUT = 300
JOB_TIMEOUT = 600


def _inputs():
    """The test scene at 64x64, depth 2, and its clusters of 32, as numpy."""
    sd = make_test_scene(viewport=(VIEWPORT, VIEWPORT), max_depth=2)
    return sd, compile_clusters_np(sd, cluster_size=32)


def _frame_parts(sd, arrays, device):
    scene = cluster_scene_from_numpy(**arrays, device=device)
    px = sd.env_pixels
    env = create_environment(px, px.shape[1], px.shape[0], device=device)
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                         VIEWPORT, VIEWPORT).as_arrays(device)
    return scene, env, cam


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(xs, ys, alives, key)`` is one
    pooled PT frame of two waves of 2,048 lanes, and returns
    ``pt_trace_frame``'s (radiance (2, 2048, 3), traced, dropped)."""
    device = resolve_device(device)
    sd, arrays = _inputs()
    scene, env, cam = _frame_parts(sd, arrays, device)
    perm, x, y = block_swizzle(VIEWPORT, VIEWPORT, N_LANES)

    def fn(xs, ys, alives, key):
        return pt_trace_frame(scene, env, cam, xs, ys, alives, key,
                              max_depth=2, backend="mxu", tile=512)

    def waves(a, dtype):
        return torch.as_tensor(a.reshape(WAVES, -1), dtype=dtype,
                               device=device)

    return fn, (waves(x, torch.int32), waves(y, torch.int32),
                waves(perm >= 0, torch.bool), rng.PRNGKey(0))


def _rank_steps(rank, n, sd, arrays):
    """One rank's part of the dry run. Returns, from every rank, the summed
    ``traced`` of the first PT step, the gathered radiance's shape and the
    throughput of the chained steps."""
    from rayaccel_tpu_torch.parallel.mesh import make_mesh

    cpu = torch.device("cpu")
    mesh = make_mesh(cpu, n)
    scene, env, cam = _frame_parts(sd, arrays, cpu)
    perm, x, y = block_swizzle(VIEWPORT, VIEWPORT, N_LANES)
    R = N_LANES // WAVES
    r0, r1 = rank * R // n, (rank + 1) * R // n
    alive = (perm >= 0) & (np.arange(N_LANES) < N_LANES // 2)

    def shard(a, dtype):
        return torch.as_tensor(a.reshape(WAVES, R)[:, r0:r1], dtype=dtype)

    xs, ys = shard(x, torch.int32), shard(y, torch.int32)
    alives = shard(alive, torch.bool)
    n_alive = int(alive.sum())
    tile = min(512, R // n)
    mesh_kw = dict(mesh=mesh, n_shards=n, reshard=True)

    def total(t):
        return int(mesh.all_reduce(torch.as_tensor(t, dtype=torch.int64)
                                   .reshape(1))[0])

    def step(key):
        rad, traced, dropped = pt_trace_frame(
            scene, env, cam, xs, ys, alives, key, max_depth=2, backend="mxu",
            tile=tile, **mesh_kw)
        return rad, total(traced), dropped

    keys = rng.split(rng.PRNGKey(0), n)
    rad, traced, dropped = step(keys[rank])
    rad_all = mesh.all_gather(rad).permute(1, 0, 2, 3).reshape(WAVES, R, 3)
    assert rad.shape == (WAVES, r1 - r0, 3), rad.shape
    assert traced >= n_alive, (traced, n_alive)
    assert bool(torch.isfinite(rad_all).all())

    # The Whitted pooled tree loop under the same imbalance: parked
    # level-0 stacks ride the exchange, radiance pieces route home.
    rad_wh, traced_wh, dropped_wh = whitted_trace_frame(
        scene, env, cam, xs, ys, alives, keys[rank], max_depth=3,
        stack_size=4, backend="mxu", tile=tile, bounce_backend="mxu",
        min_stage_width=1024, **mesh_kw)
    assert bool(torch.isfinite(rad_wh).all())
    assert total(traced_wh) >= n_alive, traced_wh

    # The per-wave path: the frame's lanes in one block a rank.
    lo, hi = rank * N_LANES // n, (rank + 1) * N_LANES // n
    rad_w, traced_w, dropped_w = pt_trace_wave(
        scene, env, cam, torch.as_tensor(x[lo:hi], dtype=torch.int32),
        torch.as_tensor(y[lo:hi], dtype=torch.int32),
        torch.as_tensor(perm[lo:hi] >= 0), keys[rank], max_depth=2,
        backend="mxu", tile=tile)
    assert bool(torch.isfinite(rad_w).all())
    assert total(traced_w) >= int((perm >= 0).sum()), traced_w

    # Throughput: steps chained by distinct keys, each synced by the sum
    # of its ray count.
    t0 = time.perf_counter()
    rays = 0
    for i in range(4):
        rays += step(rng.split(rng.PRNGKey(1 + i), n)[rank])[1]
    dt = time.perf_counter() - t0
    return dict(traced=traced, shape=tuple(rad_all.shape),
                mrays=rays / dt / 1e6,
                dropped=total(dropped + dropped_wh + dropped_w))


def _rank_main(rank, n, store, out_dir, sd, arrays):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        result = _rank_steps(rank, n, sd, arrays)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _spawn(n, sd, arrays):
    """Run :func:`_rank_main` on ``n`` spawned ranks; a rank that fails, or
    a run past ``JOB_TIMEOUT``, kills every rank and raises. Returns each
    rank's result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(n, os.path.join(tmp, "store"), tmp, sd,
                              arrays),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + JOB_TIMEOUT
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"the ranks did not finish in {JOB_TIMEOUT} s: "
                        f"{[p.exitcode for p in ctx.processes]}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def dryrun_multichip(n_devices: int) -> None:
    """Shard the frame step over ``n_devices`` gloo ranks on the CPU and
    print its two lines (module docstring). Raises if a rank fails."""
    assert N_LANES % n_devices == 0
    sd, arrays = _inputs()
    results = _spawn(n_devices, sd, arrays)
    first = results[0]
    print(f"MULTICHIP_MRAYS={first['mrays']:.4f}", flush=True)
    print(f"MULTICHIP_DROPPED={first['dropped']}", flush=True)
    print(f"dryrun_multichip OK: {n_devices} devices, {first['traced']} rays "
          f"traced, radiance {first['shape']}", flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
