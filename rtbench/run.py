"""One run of one benchmark cell of ``rayaccel_tpu_torch`` on the card.

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``rtbench/configs/<config>.json``, its scene generator
built in or in ``rtbench/scenes/<generator>.py``, its traffic in
``rtbench/traffic/<traffic>.json``, the layers in ``rtbench/layers/*.json``
and each metric's reader in ``rtbench/metrics/<metric>.py``.

1. Set-up (``setup_s``, from the start of this module): import torch and
   the program, make the scene (``rtbench/scene.py``; its layout from the
   configuration's ``layout_seed``, so that every seed traces the same
   scene, else from the seed),
   compile it, create the renderer through the public API, render the
   traffic's warm-up frames, clear the accumulation.
2. The window: ``render_frame`` back to back, closed loop, each frame
   ended by ``torch.cuda.synchronize()`` and timed on the host clock,
   until ``--seconds`` have passed. The keys (each frame's jitter and
   lanes' random streams) are made from the seed before the window. After each frame the frame buffer's rows of the sampled
   lanes are copied aside for the check.
3. On the card, the traffic's ``device_frames`` more frames under a trace
   of the device's activity alone: the device's busy time for their rays.
   With ``--trace 1``, then the traffic's ``trace_frames`` under
   ``torch.profiler`` with each layer's entry points wrapped in a span;
   the last one keeps a copy of each trace layer's input rays for the
   rooflines (``rtbench/work.py``).
4. The program is freed; the reference renders the sampled (frame, pixel)
   pairs again and the numbers are held to their limits
   (``rtbench/check.py``).

Earlier lines of standard output carry the knobs and the window's frame
times; the last line is the result. Without a CUDA device, or with fewer
than the cell asks for, it exits 3 and prints no result; if the process
has loaded JAX or the JAX package by the time the result is due (the
window, the check and the metric readers all done), it exits 4.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from collections import defaultdict  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rayaccel_tpu")
KEY_STREAM, WARMUP_STREAM = 2, 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has "
                   + ", ".join(c["name"] for c in bench["workloads"]))


def cell_metrics(bench: dict, cell: dict, section: str) -> list:
    """The metrics of ``section`` that this cell reports."""
    return [m for m in bench[section]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def load_layers(here: str = HERE) -> dict:
    """Every layer file: {id: spec}."""
    d = os.path.join(here, "layers")
    return {f[:-5]: load_json(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if f.endswith(".json")}


def load_reader(name: str, here: str = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "rtbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def frame_keys(seed: int, stream: int, n: int) -> list:
    """``n`` frame keys (pairs of uint32 words) drawn from the seed."""
    words = np.random.default_rng([seed, stream]).integers(
        0, 2 ** 32, size=(n, 2), dtype=np.uint64)
    return [(int(a), int(b)) for a, b in words]


def nvidia_smi() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


class Capture:
    """The layer inputs of one frame: {layer: [(o, d, tmin, tmax, active,
    kind)]}, kept while ``on``."""

    def __init__(self):
        self.on = False
        self.calls = defaultdict(list)
        self.entered = defaultdict(int)


def wrap_layers(layers: dict, capture: Capture):
    """Wrap each layer's entry points (``module:attribute``) in its span;
    a trace layer's wrapper also keeps its input rays while ``capture.on``.
    Returns what to put back."""
    import torch
    from rtbench import timeline, work

    def wrapped(fn, lid, entry):
        span = timeline.LAYER_PREFIX + lid

        def call(*a, **kw):
            capture.entered[lid] += 1
            if capture.on and entry.get("kind"):
                with torch.profiler.record_function(timeline.HARNESS):
                    capture.calls[lid].append((*work.captured(
                        a[entry["rays"]], kw.get(entry["active"])),
                        entry["kind"]))
            with torch.profiler.record_function(span):
                return fn(*a, **kw)
        return call

    restore = []
    for lid, spec in layers.items():
        for entry in spec["entries"]:
            modname, attr = entry["entry"].split(":")
            mod = importlib.import_module(modname)
            orig = getattr(mod, attr)
            setattr(mod, attr, wrapped(orig, lid, entry))
            restore.append((mod, attr, orig))
    return restore


class Run:
    """What the metric readers read."""

    def __init__(self):
        self.setup_s = None
        self.frame_ms = []
        self.window_s = None
        self.rays = None
        self.timeline = None
        self.device_busy_s = None
        self.device_window_s = None
        self.device_rays = None
        self.captured_frame = None
        self._work = {}
        self._work_fn = None

    def work(self, layer: str):
        """(operations, bytes) of the captured frame's calls of ``layer``,
        or None when it made none."""
        if layer not in self._work:
            self._work[layer] = self._work_fn(layer) if self._work_fn else None
        return self._work[layer]


def merged(base: dict, extra: dict | None) -> dict:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = {**out[k], **v} if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device, t0: float, overrides: dict | None = None,
             here: str = HERE, log=emit, after_setup=None):
    """One run of ``cell``; returns (result, check numbers). ``overrides``
    ({"config": ..., "traffic": ...}, merged key by key) serve the tests,
    which run it at a small size on the CPU, and the control;
    ``after_setup(renderer)`` plants a fault (``rtbench/faults.py``) and
    may return a function that takes it out again."""
    import torch
    marks = [("torch", time.perf_counter())]

    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch.scene.clusters import compile_clusters
    from rayaccel_tpu_torch.scene.data import SceneData
    from rtbench import check, scene, timeline, work
    from rtbench.reference import render
    marks.append(("program", time.perf_counter()))

    overrides = overrides or {}
    config = merged(load_json(os.path.join(here, "configs",
                                           cell["config"] + ".json")),
                    overrides.get("config"))
    traffic = merged(load_json(os.path.join(here, "traffic",
                                            cell["traffic"] + ".json")),
                     overrides.get("traffic"))
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # ---- set-up ----
    sc_cfg = config["scene"]
    arrays = scene.find(sc_cfg["generator"], here)(
        sc_cfg.get("layout_seed", seed), max_depth=traffic["max_depth"],
        **sc_cfg["args"])
    sd = SceneData(**arrays)
    marks.append(("scene", time.perf_counter()))
    conf = {**config["configuration"], **traffic.get("configuration", {})}
    cfg = racc.Configuration(**conf)
    ctx = racc.create_context(cfg, device=device)
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, sd.viewport_width,
                              sd.viewport_height)
    cluster_scene = compile_clusters(sd, cluster_size=config["cluster_size"],
                                     device=device)
    marks.append(("compile", time.perf_counter()))
    renderer = getattr(racc, config["renderer"])(
        ctx, cam, sd, tpu_scene=cluster_scene,
        **traffic.get("renderer_args", {}))
    marks.append(("renderer", time.perf_counter()))
    for key in frame_keys(seed, WARMUP_STREAM, traffic["warmup_frames"]):
        renderer.render_frame(key)
        sync()
        marks.append(("warmup_frame", time.perf_counter()))
    renderer.clear()
    undo = after_setup(renderer) if after_setup else None
    wave = min(cfg.wave_size, cfg.max_rays_in_flight)
    lane_pixel, _, _ = render.lane_order(sd.viewport_width,
                                         sd.viewport_height, wave)
    lanes = check.sample_lanes(seed, lane_pixel, traffic["check_pixels"])
    lanes_dev = torch.as_tensor(lanes, device=device)
    keys = frame_keys(seed, KEY_STREAM, traffic["max_frames"])
    rays0, dropped0 = renderer.rays_traced_total, renderer.dropped
    sync()
    log({"knobs": {
        "cell": cell["name"], "seed": seed, "seconds": seconds,
        "config": config["name"], "traffic": traffic,
        "configuration": {k: getattr(cfg, k) for k in
                          config["configuration"]},
        **cfg.engine_opts().as_dict(), **cfg.pool_knobs(),
        "routes": {"renderer": config["renderer"],
                   "primaries": renderer.backend,
                   "bounces": renderer.bounce_backend,
                   "pooled": renderer.pooled, "precision": cfg.precision}},
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if cuda else None,
        "nvidia_smi": nvidia_smi() if cuda else None,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "setup_steps_s": [[name, t - prev] for (name, t), (_, prev) in zip(
            marks, [("start", t0)] + marks)]})

    # ---- the window ----
    run = Run()
    snaps, frame_ms, frame_dropped = [], [], []
    attempted = failed = 0
    last_dropped = dropped0
    t_win = time.perf_counter()
    run.setup_s = t_win - t0
    deadline = t_win + seconds
    while True:
        ts = time.perf_counter()
        try:
            renderer.render_frame(keys[attempted])
            snaps.append(renderer.frame_buffer.index_select(0, lanes_dev))
            sync()
        except Exception:  # noqa: BLE001 - a frame that raises is a failure
            traceback.print_exc()
            failed += 1
            snaps.append(None)
            sync()
        te = time.perf_counter()
        attempted += 1
        frame_ms.append((te - ts) * 1e3)
        d = renderer.dropped
        frame_dropped.append(d - last_dropped)
        failed += d > last_dropped
        last_dropped = d
        if te >= deadline or attempted == len(keys):
            break
    run.window_s = te - t_win
    run.frame_ms = frame_ms
    run.rays = renderer.rays_traced_total - rays0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    image = renderer.image()
    spp = renderer.spp
    log({"window": {"frames": attempted, "seconds": run.window_s,
                    "rays": run.rays, "frame_ms": frame_ms,
                    "dropped": frame_dropped,
                    "peak_mem_gib": peak / 2 ** 30}})

    # ---- the device's frames ----
    # The traffic's ``device_frames`` more frames under a trace of the
    # device's activity alone, each ended by a device-wide synchronize:
    # the device's busy time for the rays they trace, and its idle share.
    # The profiler's host work does not stretch the device's operations,
    # and the device's busy time does not wait on the host.
    n_dev = traffic["device_frames"]
    n_trace = traffic["trace_frames"] if trace else 0
    more = frame_keys(seed, KEY_STREAM,
                      len(keys) + n_dev + n_trace)[len(keys):]
    breakdown = None
    capture = Capture()
    t_device = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rtbench-")
    try:
        if cuda:
            rays_d = renderer.rays_traced_total
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                sync()
                for key in more[:n_dev]:
                    renderer.render_frame(key)
                    sync()
            run.device_rays = renderer.rays_traced_total - rays_d
            run.device_busy_s, run.device_window_s = timeline.sync_window(
                prof.profiler.kineto_results.events())

        # ---- the traced frames ----
        t_trace = time.perf_counter()
        if trace:
            layers = load_layers(here)
            residual = next((lid for lid, s in layers.items()
                             if s.get("residual")), None)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            restore = wrap_layers(layers, capture)
            try:
                with torch.profiler.profile(activities=acts) as prof:
                    for i, key in enumerate(more[n_dev:]):
                        capture.on = i == n_trace - 1
                        with torch.profiler.record_function(timeline.FRAME):
                            renderer.render_frame(key)
                            with torch.profiler.record_function(
                                    timeline.HARNESS):
                                sync()
                capture.on = False
            finally:
                for mod, attr, orig in restore:
                    setattr(mod, attr, orig)
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            run.timeline = timeline.Timeline(timeline.load(path), residual)
            if run.device_window_s is None:
                run.device_busy_s = run.timeline.busy_s
                run.device_window_s = run.timeline.window_s
            breakdown = run.timeline.breakdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    failed += renderer.dropped > last_dropped

    t_check = time.perf_counter()
    if undo:
        undo()

    # ---- the program freed, the reference ----
    del renderer, cluster_scene, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = render.build(arrays, wave, device)
    params = {"max_depth": traffic["max_depth"],
              **traffic.get("renderer_args", {})}
    if conf.get("sampler", "uniform") != "uniform":
        params["sampler"] = conf["sampler"]
    frames = [f for f in check.sample_frames(seed, attempted,
                                             traffic["check_frames"])
              if snaps[f] is not None and (f == 0 or snaps[f - 1] is not None)]
    zero = torch.zeros_like(lanes_dev, dtype=torch.float32)[:, None].expand(
        -1, 3)
    port = np.stack([(snaps[f] - (snaps[f - 1] if f else zero)).cpu().numpy()
                     for f in frames])
    ref_rad, ref_rays = check.reference_samples(
        ref, config["reference"], params, frames, [keys[f] for f in frames],
        lanes, device)
    last = snaps[-1].cpu().numpy() if snaps[-1] is not None else np.nan
    pixels = lane_pixel[lanes]
    image_gap = float(np.max(np.abs(image.reshape(-1, 3)[pixels]
                                    - last / max(spp, 1))))
    numbers = check.compare(
        port, ref_rad, run.rays / attempted, ref_rays,
        sd.viewport_width * sd.viewport_height, image_gap,
        last_dropped - dropped0, traffic["limits"])

    if trace:
        def layer_work(layer):
            calls = capture.calls.get(layer)
            return work.layer_work(ref.geo, calls) if calls else None
        run._work_fn = layer_work
        run.captured_frame = run.timeline.n_frames - 1
    t_metrics = time.perf_counter()
    section = "per_layer" if trace else "end_to_end"
    due = cell_metrics(bench, cell, section)
    metrics, unread = {}, []
    for m in due:
        value = load_reader(m["name"], here)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif cuda or m["source"] != "device_trace":
            unread.append(m["name"])
    # A metric due in this cell that its reader found nothing for, or a
    # layer that its metrics name and that the traced frames never
    # entered: the code has gone out of the harness's sight (an engine
    # called under another name, say), a fault and not a metric to drop.
    numbers["metrics_unread"] = {"value": len(unread), "limit": 0}
    unseen = []
    if trace:
        named = {m["layer"] for m in due}
        unseen = [lid for lid, spec in load_layers(here).items()
                  if spec["entries"] and not spec.get("residual")
                  and spec["layer"] in named and not capture.entered[lid]]
        numbers["layers_unseen"] = {"value": len(unseen), "limit": 0}
    if unread or unseen:
        print("due in this cell and not read: " + ", ".join(unread + unseen),
              file=sys.stderr, flush=True)
    if trace:
        log({"work": {
            layer: {"flop": w[0], "bytes": w[1],
                    "bound_ms": work.bound_ms(*w),
                    "bound_by": work.bound_by(*w),
                    "device_ms": run.timeline.layer_ms(
                        layer, frame=run.captured_frame)}
            for layer in capture.calls if (w := run.work(layer))}})
    log({"phases_s": {"setup": run.setup_s, "window": run.window_s,
                      "device": t_trace - t_device,
                      "traced": t_check - t_trace,
                      "check": t_metrics - t_check,
                      "metrics": time.perf_counter() - t_metrics}})
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else str(device),
           "count": cell["chips"], "memory_peak_bytes": peak}
    if trace:
        dev.update(busy_s=run.device_busy_s, window_s=run.device_window_s)
    result = {"correct": failed == 0 and check.passed(numbers),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = numbers
    return result, numbers


def forbidden_modules() -> list:
    """The top-level names of ``FORBIDDEN`` that this process has loaded,
    each compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_bench()
    try:
        cell = find_cell(bench, args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cell {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    result, numbers = run_cell(
        bench, cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print("loaded in this process by the end of the window: "
              + ", ".join(found), file=sys.stderr)
        return 4
    emit(result)
    for name, n in numbers.items():
        print(f"check {name} {n['value']} limit {n['limit']}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
