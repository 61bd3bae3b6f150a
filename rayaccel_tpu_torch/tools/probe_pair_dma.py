"""The multi-block pair probe P4 on one CUDA device: counterpart of the
repo-root ``tools/probe_pair_dma.py``.

    python -m rayaccel_tpu_torch.tools.probe_pair_dma               # the card
    python -m rayaccel_tpu_torch.tools.probe_pair_dma --device cpu \\
        --width 64 --height 64 --wave-size 4096                     # plain

The probe asks whether K3, the pair kernel, gains from another staging.
:func:`pair_hit_mb` (``csrc/pair_hit_mb.cu``, replacing ``_kernel_mb``)
walks K3's own balanced work (64-pair units, a grid of the CTAs the card
holds at once, each CTA a contiguous share of the units), so the probe's
several pair blocks a grid step are what a share spans; only the staging
differs: a producer warp stages each change of cluster with one TMA
tensor copy (the 48 live bytes of each G3 row, K3's layout) into a ring
of ``stages`` stages with a full and an empty mbarrier each, where K3
(``csrc/pair_hit.cu``) stages with 16-byte ``cp.async`` chunks from every
thread into two. Its words equal K3's on every pair an item covers.
:func:`plan` computes the kernel's counters on the host from the items
and the grid alone.

The entry point rebuilds the probe's frame-width bounce pool: the
battlefield-like scene, clusters of 128, 1280x720 (983,040 lanes), the
first bounce of the path tracer's stage 1 under key 3, K = 4 from K2
(``ops/trace_sparse.py:_select``) and the pair arrays of
``_lattice_pairs`` and ``_pair_inputs`` (the headline shape), then the
pair arrays of that bounce's first restart pass (the narrow shape). For
each it prints a line naming the shape and the probe's two lines:

- ``mb_exactness``: ``n_diff``, the covered pairs whose word differs from
  K3's (at each ring depth tried), ``n``, the covered pairs, and whether
  the kernel's counters equal the plan's at each;
- ``pair_kernel_frame_width``: ``base_ms`` (K3, timed first and last),
  ``mb_ms`` (at ``stages``, the first of ``--stages``),
  ``mb_ms_by_stages``, ``items``, ``pairs``, P4's counters and the plan's
  at each depth (units tested, CTAs, clusters and bytes staged), and K3's
  counters.

Times are CUDA-event means on the card (None elsewhere). It exits
non-zero when ``n_diff`` is above 0 or a counter differs from the plan's.
With no CUDA device and no ``--device`` it raises. ``--min-ctas N`` runs
it in a copy of the package whose P4 is built for N CTAs an SM (the
register cap its 288 threads get; the tree's is K3's 3), and the device
line then carries ptxas's report of that build.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.ops import _kernels
from rayaccel_tpu_torch.ops import trace_sparse as sparse
from rayaccel_tpu_torch.utils.profiling import cuda_ms

SP = 1024            # pairs a block of the plain walk (the port's sp_tile)
UNIT_PAIRS = 64      # K3's work unit
STAGES = 2           # ring stages (chosen on the card: PERF.md)
# The ring depths the entry point times, the chosen one first.
STAGE_SWEEP = (STAGES, *(S for S in (2, 3, 4) if S != STAGES))
K = 4                # the clusters a ray takes in the first pass
KEY = 3

# The arguments of cuTensorMapEncodeTiled that the host checks name, by the
# code the kernel's entry point returns above _ENCODE_ARG.
_ENCODE_ARG = 10000
_ENCODE_ENTRY = 10100
_ENCODE_DRIVER = 20000
_ENCODE_ARGS = {1: ("globalAddress", "G3 must start on 16 bytes"),
                2: ("globalDim", "a dimension of G3 is out of range"),
                3: ("globalStrides", "a stride of G3 is not a multiple of "
                                     "16 bytes below 2^40"),
                4: ("boxDim", "the box of one cluster is out of range")}


def stage_bytes(C: int) -> int:
    """Bytes P4 stages for one cluster of C: the 48 live bytes of each of
    its 4C G3 rows."""
    return 4 * C * 48


def block_runs(items, sp: int, n_blocks: int):
    """The probe's per-block run offsets from the port's ``items``
    ((n_items, 3) int32 [start, end, cluster], sorted by start): ``starts``
    (n_blocks + 1,) int32, the first item of each SP-pair block (the
    block of an item is start // sp; starts[n_blocks] is the items of the
    array's blocks), and ``clusters`` (n_items,) int32, each run's
    cluster."""
    block = (items[:, 0] // sp).contiguous()
    starts = torch.searchsorted(
        block, torch.arange(n_blocks + 1, dtype=block.dtype,
                            device=items.device)).to(torch.int32)
    return starts, items[:, 2].contiguous()


def resident_ctas(stages: int, guard_tmax: bool = False) -> int:
    """The CTAs of P4 the current card holds at once with a ring of
    ``stages`` stages (asked once a form and depth)."""
    n = _kernels.library().racc_pair_hit_mb_resident(int(guard_tmax), stages)
    if n <= 0:
        raise RuntimeError(f"racc_pair_hit_mb_resident: CUDA error {-n}")
    return n


def launch_grid(P: int, n_items: int, stages: int,
                guard_tmax: bool = False) -> int:
    """P4's grid on the card, as K3's launcher sizes its own: the CTAs the
    card holds at once, capped by the units ``n_items`` runs of ``P``
    pairs can have."""
    return min(n_items + P // UNIT_PAIRS, resident_ctas(stages, guard_tmax))


def plan(items, P: int, n_c: int, C: int, grid: int) -> dict:
    """P4's counters on ``grid`` CTAs, from the items alone and apart from
    the kernel: ``units`` (the 64-pair work units of the runs that name a
    cluster of the scene and pairs of the array), ``ctas`` (the CTAs whose
    share has a unit), ``clusters_staged`` (each share's changes of
    cluster, its first unit included), ``bytes_staged`` (those times
    :func:`stage_bytes`) and ``shares`` ((grid, 2) int64 [first, end) of
    each CTA's units, K3's cut: total * b // grid)."""
    it = items.to("cpu", torch.int64)
    s, e, c = it[:, 0], it[:, 1], it[:, 2]
    ok = (s >= 0) & (e > s) & (e <= P) & (c >= 0) & (c < n_c)
    n_units = torch.where(ok, (e - s + UNIT_PAIRS - 1) // UNIT_PAIRS, 0)
    total = int(n_units.sum())
    bounds = total * torch.arange(grid + 1, dtype=torch.int64) // grid
    u0, u1 = bounds[:-1], bounds[1:]
    cluster = torch.repeat_interleave(c, n_units)
    unit = torch.arange(total)
    cta = torch.searchsorted(u0, unit, right=True) - 1
    change = unit == u0[cta]
    change[1:] |= cluster[1:] != cluster[:-1]
    staged = int(change.sum())
    return dict(units=total, ctas=int((u1 > u0).sum()),
                clusters_staged=staged, bytes_staged=staged * stage_bytes(C),
                shares=torch.stack([u0, u1], dim=1))


def _check(code: int) -> None:
    """Raise on the code of racc_pair_hit_mb: an argument of the tensor map
    that the host refused (named), or a CUDA error."""
    if code >= _ENCODE_DRIVER:
        raise RuntimeError(f"racc_pair_hit_mb: cuTensorMapEncodeTiled refused "
                           f"the tensor map over G3 (CUresult "
                           f"{code - _ENCODE_DRIVER})")
    if code == _ENCODE_ENTRY:
        raise RuntimeError("racc_pair_hit_mb: the driver has no "
                           "cuTensorMapEncodeTiled")
    if code > _ENCODE_ARG:
        name, why = _ENCODE_ARGS[code - _ENCODE_ARG]
        raise ValueError(f"racc_pair_hit_mb: the tensor map over G3 refused "
                         f"{name}: {why}")
    _kernels.check(code, "racc_pair_hit_mb")


def pair_hit_mb(Fp, G3, items, col_bits: int, guard_tmax: bool, *,
                stages: int = STAGES, stats=None, err=None,
                smem: int = 0) -> torch.Tensor:
    """P4: :func:`ops.trace_sparse.pair_hit`'s function (same arguments and
    result: the miss marker where no item covers a pair) on K3's work
    units, each change of cluster staged by a producer warp's TMA tensor
    copy into a ring of ``stages`` stages (2 to 4). The probe's blocks a
    CTA are gone: a CTA's share of the units sets them.

    ``stats`` (optional, a (3,) int64 CUDA tensor) gains the units tested,
    the CTAs that tested any and the bytes staged (equal to :func:`plan`'s
    on :func:`launch_grid`). ``err`` (optional, a (2,) int32 CUDA tensor of
    zeros) takes the kernel's error word for the caller to check
    (``_kernels.check_device``); without it the wrapper reads one after the
    launch and raises on a failure (a barrier wait that timed out, too
    little shared memory). A tensor map the host cannot encode (a G3 that
    is not 16-byte aligned) raises, naming the argument. ``smem`` (bytes
    of dynamic shared memory, 0: the ring for clusters of C) is for the
    card tests. On a CPU tensor it runs :func:`pair_hit_mb_plain`."""
    if Fp.device.type == "cpu":
        return pair_hit_mb_plain(Fp, G3, items, col_bits, guard_tmax)
    P = Fp.shape[0]
    n_items = items.shape[0]
    _kernels.require(Fp, "Fp", torch.float32, (P, 16))
    _kernels.require(G3, "G3", torch.float32)
    if G3.dim() != 3 or G3.shape[1] % 4 or G3.shape[2] != 16:
        raise ValueError(f"G3 must have shape (n_c, 4C, 16), got "
                         f"{tuple(G3.shape)}")
    n_c, C = G3.shape[0], G3.shape[1] // 4
    if not 1 <= C <= 128:
        raise ValueError(f"clusters of {C} triangles: the kernel takes 1 to "
                         f"128")
    _kernels.require(items, "items", torch.int32, (n_items, 3))
    if not 2 <= stages <= 4:
        raise ValueError(f"stages must be 2, 3 or 4, got {stages}")
    if stats is not None:
        _kernels.require(stats, "stats", torch.int64, (3,))
    out = torch.full((P,), sparse._MISS_BITS, dtype=torch.int32,
                     device=Fp.device)
    if n_items == 0 or P == 0:
        return out
    own = err is None
    if own:
        err = torch.zeros(2, dtype=torch.int32, device=Fp.device)
    else:
        _kernels.require(err, "err", torch.int32, (2,))
    ustart = torch.empty(n_items + 1, dtype=torch.int32, device=Fp.device)
    _check(_kernels.library().racc_pair_hit_mb(
        _kernels.ptr(Fp), _kernels.ptr(G3), _kernels.ptr(items),
        _kernels.ptr(ustart), n_items, _kernels.ptr(out),
        None if stats is None else _kernels.ptr(stats), _kernels.ptr(err),
        P, n_c, C, col_bits, int(guard_tmax), stages,
        launch_grid(P, n_items, stages, guard_tmax), smem,
        _kernels.stream()))
    pair_hit_mb.launches += 1
    if own:
        _kernels.check_device(err, "racc_pair_hit_mb")
    return out


pair_hit_mb.launches = 0


def pair_hit_mb_plain(Fp, G3, items, col_bits: int, guard_tmax: bool, *,
                      sp: int = SP) -> torch.Tensor:
    """Plain torch version of P4: K3's plain arithmetic
    (``ops/trace_sparse.py:pair_words``) in the TPU probe's walk, SP-pair
    block by block (:func:`block_runs`), one run at a time,
    on the run's pairs whose lane word names its cluster. An item that
    names no cluster of the scene or no pair of the array is skipped, as
    the kernel (and K3) skip it."""
    P = Fp.shape[0]
    n_c = G3.shape[0]
    out = torch.full((P,), sparse._MISS_BITS, dtype=torch.int32,
                     device=Fp.device)
    starts = block_runs(items, sp, -(-P // sp))[0].tolist()
    lanes = Fp[:, 12].contiguous().view(torch.int32)
    G10 = G3[:, :, :10]
    runs = items.tolist()
    for b in range(len(starts) - 1):
        for s, e, cl in runs[starts[b]:starts[b + 1]]:
            if not (0 <= s < e <= P and 0 <= cl < n_c):
                continue
            words = sparse.pair_words(Fp[s:e], G10[cl:cl + 1], lanes[s:e],
                                      col_bits, guard_tmax)
            named = (lanes[s:e] & sparse._CL_MASK) == cl
            out[s:e] = torch.where(named, words, out[s:e])
    return out


def run(Fp, G3, items, col_bits: int, *, stages=STAGE_SWEEP,
        reps: int = 20):
    """The probe on one pass's pair arrays (K3's closest-hit form, as the
    probe ran it): (``mb_exactness`` line, ``pair_kernel_frame_width``
    line) as dicts. P4 runs at each ring depth of ``stages`` (its line
    reports the first) against K3 on the same inputs; on a CUDA device its
    counters are held against :func:`plan` and the kernels are timed, K3
    first and last."""
    on_card = Fp.device.type == "cuda"
    P, n_items = Fp.shape[0], items.shape[0]
    n_c, C = G3.shape[0], G3.shape[1] // 4
    args = (Fp, G3, items, col_bits, False)

    def counters():
        return (torch.zeros(3, dtype=torch.int64, device=Fp.device)
                if on_card else None)

    k3_stats = counters()
    base = sparse.pair_hit(*args, stats=k3_stats)
    live = sparse.covered_pairs(Fp, items)[0]
    n_diff, got, want = {}, {}, {}
    for S in stages:
        stats = counters()
        mb = pair_hit_mb(*args, stages=S, stats=stats)
        n_diff[S] = int(((mb != base) & live).sum())
        if (mb[~live] != sparse._MISS_BITS).any():
            raise AssertionError(f"P4 (stages={S}) wrote a pair no item "
                                 f"covers")
        if on_card:
            got[S] = dict(zip(("units", "ctas", "bytes_staged"),
                              stats.tolist()))
            p = plan(items, P, n_c, C, launch_grid(P, n_items, S))
            want[S] = {k: v for k, v in p.items() if k != "shares"}
    exact = dict(stage="mb_exactness", n_diff=n_diff[stages[0]],
                 n=int(live.sum()), n_diff_by_stages=n_diff,
                 counters_equal_plan=(
                     {S: all(got[S][k] == want[S][k] for k in got[S])
                      for S in stages} if on_card else None))
    base_ms, mb_ms = None, {S: None for S in stages}
    if on_card:
        err = torch.zeros(2, dtype=torch.int32, device=Fp.device)
        base_ms = cuda_ms(lambda: sparse.pair_hit(*args), reps)
        for S in stages:
            mb_ms[S] = cuda_ms(lambda: pair_hit_mb(*args, stages=S, err=err),
                               reps)
        base_ms = (base_ms + cuda_ms(lambda: sparse.pair_hit(*args),
                                     reps)) / 2
        _kernels.check_device(err, "racc_pair_hit_mb")
    timing = dict(stage="pair_kernel_frame_width", base_ms=base_ms,
                  mb_ms=mb_ms[stages[0]], mb_ms_by_stages=mb_ms,
                  items=n_items, pairs=P, stages=stages[0],
                  counters=got or None, plan=want or None,
                  k3_counters=(dict(zip(("units", "ctas", "clusters_staged"),
                                        k3_stats.tolist()))
                               if on_card else None))
    return exact, timing


def bounce_pairs(device, width: int = 1280, height: int = 720,
                 wave_size: int = 65536, cluster_size: int = 128,
                 narrow: bool = False):
    """The probe's pool: pass 1 of the first bounce of a path-traced frame
    of the battlefield-like scene at ``width`` x ``height`` (waves of
    ``wave_size`` lanes) under key 3, as pair arrays; with ``narrow`` the
    pair arrays of that bounce's first restart pass instead (the narrow
    shape: the unresolved rays, a few pairs a run), as ``trace_sparse``
    hands them to K3. Returns (Fp, G3, items, col_bits, lanes)."""
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.ops.intersect import safe_inv_dir
    from rayaccel_tpu_torch.render import pathtracer
    from rayaccel_tpu_torch.scene.clusters import compile_clusters
    from rayaccel_tpu_torch.scene.loader import make_battlefield_like

    sd = make_battlefield_like(viewport=(width, height), max_depth=2)
    cs = compile_clusters(sd, cluster_size=cluster_size, device=device)
    ctx = racc.create_context(racc.Configuration(
        wave_size=wave_size, trace_block=min(1024, wave_size)), device=device)
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, width, height)
    r = racc.PathTracingRenderer(ctx, cam, sd, tpu_scene=cs)
    opts = ctx.configuration.engine_opts()
    state, _ = pathtracer._stage1(cs, cam.as_arrays(device), r._wave_x,
                                  r._wave_y, r._wave_alive,
                                  rng.PRNGKey(KEY), 2, "pallas", r.tile, opts)
    pool = state["rays"]
    N = pool.o.shape[0]
    col_bits = max((cs.cluster_size - 1).bit_length(), 1)
    if narrow:
        Fp, items = _restart_pass(cs, pool, state["alive"], opts)
        return Fp, cs.G3, items, col_bits, N
    tmax = torch.where(state["alive"], pool.tmax,
                       torch.full_like(pool.tmax, -1))
    lat_valid, lat_id, _ = sparse._select(cs, pool.o,
                                          safe_inv_dir(pool.d), pool.tmin,
                                          tmax, K)
    cap = min(max(SP, -(-opts.pair_budget * N // SP) * SP),
              -(-K * N // SP) * SP)
    cl, ray, rank, _ = sparse._lattice_pairs(lat_valid, lat_id, cap)
    Fp, items = sparse._pair_inputs(pool.o, pool.d, pool.tmin, tmax, cl, ray,
                                    rank, SP)
    return Fp, cs.G3, items, col_bits, N


def _restart_pass(cs, pool, alive, opts):
    """(Fp, items) of the second pass of ``trace_sparse`` on ``pool`` (its
    first restart pass) with the engine's options: K3's wrapper is
    replaced, while the trace runs, by one that keeps each non-empty
    pass's inputs."""
    passes = []
    pair_hit = sparse.pair_hit

    def keep(Fp, G3, items, *a, **kw):
        if items.shape[0]:
            passes.append((Fp.clone(), items.clone()))
        return pair_hit(Fp, G3, items, *a, **kw)

    # The wrapper counts its launches on the module's name, keep's here.
    keep.launches = keep.guard_launches = keep.launches_bf16 = 0
    sparse.pair_hit = keep
    try:
        sparse.trace_sparse(cs, pool, active=alive, k_pairs=opts.k_pairs,
                            pair_budget=opts.pair_budget,
                            sp_tile=opts.sp_tile, max_passes=opts.max_passes,
                            k_first=opts.k_first, k_restart=opts.k_restart)
    finally:
        sparse.pair_hit = pair_hit
    if len(passes) < 2:
        raise RuntimeError("the first bounce ran no restart pass")
    return passes[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA "
                             "device; 'cpu' runs the plain versions)")
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--wave-size", type=int, default=65536)
    parser.add_argument("--stages", default=",".join(map(str, STAGE_SWEEP)),
                        help="ring stages to try (2 to 4), the reported "
                             "one first")
    parser.add_argument("--reps", type=int, default=20,
                        help="timed launches a kernel (card only)")
    parser.add_argument("--min-ctas", type=int, default=None,
                        help="run in a copy of the package whose P4 is "
                             "built for this many CTAs an SM (its register "
                             "cap; the tree's is 3) instead")
    args = parser.parse_args(argv)
    if args.min_ctas is not None:
        return _in_variant(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        _kernels.library()   # built here, so that its ptxas report is read
    failed = False
    for shape in ("headline", "narrow"):
        Fp, G3, items, col_bits, lanes = bounce_pairs(
            device, args.width, args.height, args.wave_size,
            narrow=shape == "narrow")
        print(json.dumps(dict(device=str(device), shape=shape, lanes=lanes,
                              pairs=Fp.shape[0],
                              name=(torch.cuda.get_device_name(device)
                                    if device.type == "cuda" else None),
                              ptxas=_ptxas("pair_hit_mb_kernel"))),
              flush=True)
        exact, timing = run(Fp, G3, items, col_bits,
                            stages=tuple(int(S) for S in
                                         args.stages.split(",")),
                            reps=args.reps)
        print(json.dumps(exact), flush=True)
        print(json.dumps(timing), flush=True)
        failed |= (any(exact["n_diff_by_stages"].values())
                   or not all((exact["counters_equal_plan"] or {}).values()))
    return 1 if failed else 0


def _ptxas(kernel: str) -> list:
    """ptxas's report (stack, spills, registers) of each form of
    ``kernel`` in the build this process ran (empty if it built none)."""
    lines, out = _kernels.build_log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            out += [ln.strip() for ln in lines[i + 1:i + 4]
                    if "spill" in ln or "registers" in ln]
    return out


def _in_variant(args) -> int:
    """The entry point with ``args`` in a copy of the package under
    ``_build/variants/`` (``tools/bf16_variants.py``'s) whose
    ``csrc/pair_hit_mb.cu`` sets ``kMbMinCtas`` to ``args.min_ctas``; its
    kernels are built there."""
    import os
    import subprocess

    from rayaccel_tpu_torch.tools.bf16_variants import _ROOT, _copy
    root = _copy(f"mb_min_ctas_{args.min_ctas}",
                 ("pair_hit_mb.cu", "kMbMinCtas", args.min_ctas))
    argv = ["--width", str(args.width), "--height", str(args.height),
            "--wave-size", str(args.wave_size), "--stages", args.stages,
            "--reps", str(args.reps)]
    if args.device is not None:
        argv += ["--device", args.device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, _ROOT]))
    return subprocess.run(
        [sys.executable, "-m", "rayaccel_tpu_torch.tools.probe_pair_dma",
         *argv], cwd=root, env=env, timeout=600).returncode


if __name__ == "__main__":
    sys.exit(main())
