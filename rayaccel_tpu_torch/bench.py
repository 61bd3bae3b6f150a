"""The BASELINE.md config matrix on the battlefield-like scene, on the card:
counterpart of the repo-root ``bench.py``.

    python -m rayaccel_tpu_torch.bench

Mrays/s with rays counted at intersection dispatch (the renderers'
``rays_traced``, shadow rays included), one JSON line a config:

- first one ``bench_knobs`` line: the knobs, ``engine_opts().as_dict()``
  and ``pool_knobs()``, the device, ``nvidia-smi``'s name and power limit
  and ``torch.version.cuda``;
- the headline (config 2) runs first and is exempt from the deadline
  (``BENCH_DEADLINE_S``, default 4500 s); past it, every other config
  prints a ``skipped_deadline`` line;
- a config that raises prints an ``error`` line and the matrix carries on,
  but the process then exits non-zero, as it does when the oracle's gate
  fails;
- the headline is printed again as the last line (a headline-shaped
  ``error`` line if it failed);
- every config line carries ``dropped``, the renderer's overflow count.

Configs, in order (``BENCH_ONLY``, default ``2,5,1,6,3,4,7``): 2 PT at
depth 2 (``BENCH_FRAMES`` frames, default 8); 5b PT under a one-rank mesh
(frames // 4); 1 ``WhittedRenderer(shadows=True, primary_only=True)`` at
depth 1; 6 Whitted at depth 8 (frames // 2); 3 PT at depth 8 (frames // 2);
4 PT with the stratified sampler; 5a ``python -m
rayaccel_tpu_torch.tools.dryrun`` in a subprocess (eight gloo ranks on the
CPU); 7 ``tools/oracle_lib.py``'s ray-set oracle and image oracle
(``BENCH_RMSE_SPP`` spp, default 2). ``BENCH_BACKEND``, ``BENCH_WAVE``,
``BENCH_TILE`` and ``BENCH_CS`` set the engine, wave size, trace block and
cluster size.

Metric names are ``bench.py``'s, except three that named the TPU:
``multichip_mesh1_tpu_mrays_per_s`` is ``multichip_mesh1_gpu_mrays_per_s``
here, ``oracle_tpu`` is ``oracle_gpu`` and ``oracle_tpu_rows`` is
``oracle_gpu_rows``. ``bench.py``'s ``vs_baseline`` (against a TPU
target) is not printed. The run is on the current CUDA device; with none
it raises: there is no device probe and no fallback. The kernels build at first use into
``rayaccel_tpu_torch/_build/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import torch

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.scene.clusters import compile_clusters
from rayaccel_tpu_torch.scene.loader import make_battlefield_like

HEADLINE = "pt_battlefield_mrays_per_s_per_chip"
DEFAULT_CONFIGS = "2,5,1,6,3,4,7"
# Rays of each of the oracle's ray sets, and ranks of the dry run.
ORACLE_RAYS = 65536
DRYRUN_RANKS = 8
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(obj):
    print(json.dumps(obj), flush=True)


def run_config(renderer, frames, key0=1):
    """One warm-up frame, then ``frames`` timed frames with premade keys
    and no host read of ours inside the loop; the ray counter is read once
    at the end. Returns (Mrays/s, frame ms, rays)."""
    renderer.render_frame(rng.PRNGKey(0))
    keys = [rng.PRNGKey(key0 + i) for i in range(frames)]
    base = renderer.rays_traced_total                 # syncs the warm-up
    t0 = time.perf_counter()
    for k in keys:
        renderer.render_frame(k)
    rays = renderer.rays_traced_total - base
    if renderer.device.type == "cuda":
        torch.cuda.synchronize(renderer.device)
    dt = time.perf_counter() - t0
    return rays / dt / 1e6, dt / frames * 1e3, rays


def _nvidia_smi(device):
    """``nvidia-smi``'s name and power limit of the card, None off it."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def main(scene_data=None, device=None, environ=os.environ) -> int:
    """Run the matrix; returns the exit code (0 when every config ran and
    the oracle passed). ``scene_data`` defaults to
    ``make_battlefield_like()``, ``device`` to the current CUDA device."""
    t_start = time.perf_counter()
    deadline_s = float(environ.get("BENCH_DEADLINE_S", 4500))
    device = resolve_device(device)
    backend = environ.get("BENCH_BACKEND", "pallas")
    wave = int(environ.get("BENCH_WAVE", 128 * 128 * 4))
    tile = int(environ.get("BENCH_TILE", 1024))
    cs_size = int(environ.get("BENCH_CS", 128))
    frames = int(environ.get("BENCH_FRAMES", 8))
    rmse_spp = int(environ.get("BENCH_RMSE_SPP", 2))
    configs = set((environ.get("BENCH_ONLY") or DEFAULT_CONFIGS).split(","))
    failed = []

    base_cfg = racc.Configuration(backend=backend, wave_size=wave,
                                  trace_block=tile)
    emit({"metric": "bench_knobs", "unit": "knobs", "value": 1,
          "knobs": dict(backend=backend, wave_size=wave, trace_block=tile,
                        cluster_size=cs_size, frames=frames,
                        **base_cfg.engine_opts().as_dict(),
                        **base_cfg.pool_knobs()),
          "device": str(device),
          "device_name": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else None),
          "nvidia_smi": _nvidia_smi(device), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    sd = make_battlefield_like() if scene_data is None else scene_data
    cluster_scene = compile_clusters(sd, cluster_size=cs_size, device=device)

    def guarded(metric, fn, skip_deadline=True):
        """One config, one failure domain: an exception prints the
        config's error line and the matrix carries on; it is remembered
        for the exit code. The headline passes ``skip_deadline=False``:
        the deadline protects the later configs from a slow head, and
        never skips the head itself."""
        if skip_deadline and time.perf_counter() - t_start > deadline_s:
            emit({"metric": metric, "value": 0, "unit": "skipped_deadline",
                  "elapsed_s": round(time.perf_counter() - t_start, 1)})
            return
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - one config, one domain
            traceback.print_exc()
            failed.append(metric)
            emit({"metric": metric, "value": 0, "unit": "error",
                  "error": f"{type(e).__name__}: {e}"[:500]})

    def ctx(**kw):
        return racc.create_context(racc.Configuration(
            backend=backend, wave_size=wave, trace_block=tile, **kw),
            device=device)

    def at_depth(max_depth):
        s = type(sd)(**{**sd.__dict__, "max_depth": max_depth})
        cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up,
                                  s.cam_fov, s.viewport_width,
                                  s.viewport_height)
        return s, cam

    def pt(max_depth, **ctx_kw):
        s, cam = at_depth(max_depth)
        return racc.PathTracingRenderer(ctx(**ctx_kw), cam, s,
                                        tpu_scene=cluster_scene)

    def whitted(max_depth, **kw):
        s, cam = at_depth(max_depth)
        return racc.WhittedRenderer(ctx(), cam, s, tpu_scene=cluster_scene,
                                    **kw)

    def timed(metric, renderer, n, **extra):
        mrays, frame_ms, rays = run_config(renderer, n)
        emit({"metric": metric, "value": round(mrays, 2), "unit": "Mrays/s",
              "frame_ms": round(frame_ms, 2), "rays": rays,
              "dropped": renderer.dropped, **extra})

    headline = None
    if "2" in configs:
        def cfg2():
            nonlocal headline
            r = pt(2)
            m, ms, rays = run_config(r, frames)
            headline = {"metric": HEADLINE, "value": round(m, 2),
                        "unit": "Mrays/s", "frame_ms": round(ms, 2),
                        "frames": frames, "rays": rays,
                        "dropped": r.dropped}
            emit(headline)
        guarded(HEADLINE, cfg2, skip_deadline=False)

    if "5" in configs:
        # Config 5b: the mesh code on the card, a one-rank group that
        # create_context forms; it is destroyed after, unless it was the
        # caller's.
        def cfg5b():
            import torch.distributed as dist
            own_group = not dist.is_initialized()
            try:
                timed("multichip_mesh1_gpu_mrays_per_s",
                      pt(2, mesh_shape=(1,)), max(frames // 4, 1),
                      mesh_shape=[1])
            finally:
                if own_group and dist.is_initialized():
                    dist.destroy_process_group()
        guarded("multichip_mesh1_gpu_mrays_per_s", cfg5b)

    if "1" in configs:
        guarded("whitted_primary_shadow_mrays_per_s", lambda: timed(
            "whitted_primary_shadow_mrays_per_s",
            whitted(1, shadows=True, primary_only=True), frames))

    if "6" in configs:
        guarded("whitted_depth8_mrays_per_s", lambda: timed(
            "whitted_depth8_mrays_per_s", whitted(8), max(frames // 2, 1)))

    if "3" in configs:
        guarded("pt8_fullbsdf_mrays_per_s", lambda: timed(
            "pt8_fullbsdf_mrays_per_s", pt(8), max(frames // 2, 1)))

    if "4" in configs:
        guarded("pt_stratified_mrays_per_s", lambda: timed(
            "pt_stratified_mrays_per_s", pt(2, sampler="stratified"), frames,
            spp_target=256))

    if "5" in configs:
        # Config 5a: the multi-rank dry run, gloo ranks on the CPU.
        def cfg5a():
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "rayaccel_tpu_torch.tools.dryrun",
                 str(DRYRUN_RANKS)], cwd=_ROOT, capture_output=True,
                text=True, timeout=600)
            found = dict(ln.split("=", 1) for ln in proc.stdout.splitlines()
                         if ln.startswith("MULTICHIP_"))
            ok = proc.returncode == 0 and "OK" in proc.stdout
            if not ok:
                failed.append("multichip_cpu_mesh_smoke")
            emit({"metric": "multichip_cpu_mesh_smoke", "value": int(ok),
                  "unit": "ok", "ranks": DRYRUN_RANKS,
                  "cpu_mesh_mrays_per_s": round(
                      float(found.get("MULTICHIP_MRAYS", 0)), 3),
                  "dropped": int(found.get("MULTICHIP_DROPPED", -1)),
                  "seconds": round(time.perf_counter() - t0, 1),
                  **({} if ok else {"stderr": proc.stderr[-500:]})})
        guarded("multichip_cpu_mesh_smoke", cfg5a)

    if "7" in configs:
        # Config 7: the cluster engines against each other on the card,
        # and the production frame against the lockstep-BVH engine.
        def cfg7():
            from rayaccel_tpu_torch.tools.oracle_lib import (
                run_image_oracle, run_oracle)
            rows, ok = run_oracle(cluster_scene, sd, n_rays=ORACLE_RAYS)
            if not ok:
                emit({"metric": "oracle_gpu_rows", "value": 0,
                      "unit": "detail", "rows": rows})
            img = run_image_oracle(cluster_scene, sd, n_spp=rmse_spp)
            passed = (ok and img["rmse_trimmed"] < 1e-3
                      and img["frac_flip"] < 0.005)
            if not passed:
                failed.append("oracle_gpu")
            emit({"metric": "oracle_gpu", "value": int(passed), "unit": "ok",
                  "rows": len(rows),
                  "min_hit_agree": min(r["hit_agree"] for r in rows),
                  "min_t_agree": min(r["t_within_1e3"] for r in rows),
                  "overflow": sum(r["overflow"] for r in rows),
                  "dropped": img["dropped"],
                  "image_rmse": img["image_rmse"],
                  "rmse_trimmed": img["rmse_trimmed"],
                  "frac_flip": img["frac_flip"], "rmse_spp": img["spp"],
                  "prod_seconds": round(img["prod_seconds"], 3),
                  "ref_seconds": round(img["ref_seconds"], 3)})
        guarded("oracle_gpu", cfg7)

    if headline is not None:
        emit(headline)
    elif "2" in configs:
        emit({"metric": HEADLINE, "value": 0, "unit": "error",
              "error": "headline config failed or was never attempted; "
                       "see its earlier error line"})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
