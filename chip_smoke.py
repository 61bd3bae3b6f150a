#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels     # phases 1-3 only, a kernel's quick check

Run from the root of a checkout. The script imports ``torch``,
``rayaccel_tpu_torch`` and the benchmark's NumPy scene generator
``rtbench/scenes/spd_tetra.py`` only (never JAX), needs one CUDA device,
and exits non-zero without printing a result when there is none or when
the package is missing. Phases, one JSON line each:

1. device: the card's name, and ``nvidia-smi``'s name and power limit
   (also printed raw on a line of their own);
2. build: the hand-written kernels (``rayaccel_tpu_torch/csrc``)
   compiled by nvcc for sm_90a (one nvcc per source, in parallel), with
   ptxas's register report;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the headline shapes (battlefield-like scene, 827 clusters of 128):
   K1 on one 65,536-ray primary wave, K2 on the 983,040-lane bounce pool
   (k = 4, then k = 8 with the first call's spill words) which must be
   bitwise equal, the dense cull and queue of K1's wave (``cull_and_queue``,
   ``csrc/dense_cull.cu``: 65,536 rays in tiles of 1,024 against 827
   boxes), which must equal ``cull_and_queue_plain`` word for word (an
   entry of -0.0 may read +0.0), its line with both ms, its bound (24
   operations a (ray, box) pair, as K2's) and ``k2_rate_ms`` (its pairs at
   K2's pair rate in the same run), K3 on pass 1 of the first bounce; then
   K2 and K3 again at a narrow shape, the first restart pass of that
   bounce (the compacted unresolved rays at their ladder width, with their
   spill words and the dead padding lanes), K2 bitwise again; K1 and K3
   must meet the oracle bar of ``tools/oracle_lib.py:run_oracle`` (hit
   agreement and t within 1e-3 relative on >= 99.95%); K4 on the shadow
   rays of K1's wave (built from its hits as the Whitted step builds
   them), whose occluded flags must agree on >= 99.95% of rays. Each
   kernel line carries its bound: ``flop`` (the fp32 operations these
   inputs need), ``bytes`` (each input read once, each output written once),
   ``bound_ms`` (the larger of the two over the H100's published peaks),
   ``bound_by``, ``share_of_bound`` (bound_ms / ms) and ``library_ms``
   (null: no single PyTorch call computes any of the four). K1 and K4 add
   ``ctas``, ``pairs_needed`` (the (ray, cluster) pairs whose tile entry
   is within the ray's answer), ``pairs_walked`` and ``clusters_staged``
   (what the kernel's warps tested and its CTAs staged, from its
   ``walked`` counter) beside ``pairs_tile_walk`` and
   ``clusters_tile_walk`` (rays and CTAs x queue length), and K1
   ``pairs_entered`` (the pairs whose box the ray itself enters within its
   answer) and ``words_differing`` from its plain version. Then the bf16
   tensor-core variants of K1, K3 and K4
   (``precision="default"``) on the same inputs, each against its plain
   version at "default" (K1 and K3 at the oracle bar, K4's flags on >=
   99.95% of rays; K1's and K4's plain versions walk in the variants'
   group of ``BF16_WARP_RAYS``), their bound over the bf16 tensor peak,
   and their agreement with the fp32 kernel as information
   (``vs_fp32``); their lines add ``staged_bytes``, the bytes of the
   scene's bf16 fragment copy of the distinct clusters queued (K1, K4) or
   named by the items (K3), which the variants stage in place of G3's
   rows (``bytes`` still counts G3's); K3's bf16 variant runs at the
   narrow shape too, and takes as many work units as the fp32 form. After
   K3's line, the ``probes`` line: the ports of the TPU probes, P1-P3
   (``tools/probe_dma.py``'s steps A-C, ``csrc/probe_dma.cu``) and P4
   (``tools/probe_pair_dma.py``'s multi-block pair kernel,
   ``csrc/pair_hit_mb.cu``, on K3's inputs), first driven through their
   entry points' ``run`` with their launch counts set to 0 just before
   and read just after (each must be > 0), then P1-P3 bit for bit against
   their plain versions, with their bound (bytes over 3.35 TB/s) and the
   one PyTorch call that computes each (``library_ms``; P3's is
   ``index_select(...).sum(0)``), P3 with its stages (``stages``,
   ``probe_dma.worklist_plan``: a copy a stage is issued before any
   wait), and P4 (K3's
   work units, a producer warp's TMA tensor copies into a ring of 2, 3
   or 4 stages) with 0 differing words from K3 on the pairs an item
   covers at every ring depth, its counters (units, CTAs, bytes staged)
   equal to the host's plan and, on K3's grid, its bytes K3's clusters
   staged x 48 bytes a row, K3's oracle bar against ``pair_hit_plain``,
   its ms at each depth beside K3's (timed first and last), and K3's
   bound; P4 again at K3's narrow shape (after K3's narrow lines); last,
   K2 past one CTA's boxes (``select_chunks_kernel``) on the bounce pool of
   a frame of SPD tetra at size factor 10 (32,768 boxes, 983,040 lanes)
   under ``rtbench/configs/spd_tetra_pt.json``, at k = 4 and then k = 8
   on its spill words, with and without the count: word for word the
   plain version's, its chunks tested (with the count) those
   ``select_chunks_needed`` counts, its ms beside a bound over the chunks
   it tested and beside the bound over every box, and its profiler name
   matched by ``KERNEL_SYMBOLS``; then K1 on the middle 65,536-ray primary
   wave of that frame (most rays through the pyramid's holes): its walk
   counts beside the tile walk's, its ms, its bound over
   ``pairs_entered``, and its words against the plain version at the
   oracle bar; then the threefry draws (``csrc/threefry.cu``, behind
   ``rng.uniform``, ``rng.lane_uniform`` and ``rng.fold_in_uniform_pair``):
   each draw shape at a wave's width (65,536) and the bounce pool's
   (983,040), word for word its plain int64 path, with its ms, the plain
   path's ms (the yardstick) and its bound (``THREEFRY_ROW_OPS``, bytes
   at 3.35 TB/s);
4. slice: ``PathTracingRenderer`` at 1280x720, depth 2, the default
   configuration: one warm-up frame and three timed frames, with every
   kernel's launch count over the timed frames (each must be > 0; every
   slice runs the threefry draws, one launch for each ``racc.shade.rng``
   span its frames open, ``rng_spans``),
   ``dropped`` (must be 0) and an image check (finite, not black);
5. gate: the same slice at 320x180 and 2 spp on the card against the same
   frames on the host CPU (plain versions, same keys), through the
   two-class gate of ``tools/oracle_lib.py:run_image_oracle``
   (rmse_trimmed < 1e-3, frac_flip < 0.5%);
6. slice ``whitted_shadow``: ``WhittedRenderer(shadows=True,
   primary_only=True)`` at 1280x720, depth 1 (primary + shadow rays): one
   warm-up and three timed frames; K1 and K4 must launch, ``dropped`` 0;
7. slice ``whitted_depth8``: ``WhittedRenderer`` at 1280x720, depth 8, on
   the pooled tree loop: one warm-up and two timed frames, with the bounce
   iterations and stage shrinks; K1, K2 and K3 must launch, ``dropped`` 0;
8. gate ``whitted_gate``: ``WhittedRenderer(shadows=True)`` at depth 8 and
   320x180, one frame on the card and on the host CPU with the same key,
   through the two-class gate; on the card all four kernels, and K3 in
   its tmax-guarded any-hit form, must launch;
9. slice ``pt_wave``: ``PathTracingRenderer`` with ``regroup=False`` at
   1280x720, depth 2: every wave traced to completion on its own (K1
   primaries, K2 + K3 bounces), one warm-up and two timed frames; K1, K2
   and K3 must launch, ``dropped`` 0;
10. ``pt_stratified``: the pooled path tracer with ``sampler="stratified"``
    at 1280x720, depth 2: frame ms, ``dropped`` 0, and the host ms of one
    wave's jitter alone;
11. ``whitted_wave``: ``whitted_trace_wave`` with shadows at depth 4 on
    one 65,536-lane wave (the per-wave Whitted path, parked stacks and
    all): all four kernels must launch, ``dropped`` 0, and the radiance
    must be finite and not all zero;
12. ``engines``: the plain engines (``mxu``, ``xla``, ``bruteforce``) and
    sparse primaries on the full scene, one wave of the 320x180 viewport:
    each engine's hits against the dense engine's on the same rays by the
    oracle bar, ``trace_occlusion_mxu`` and ``trace_occlusion_bvh`` flags
    against K4's on the wave's shadow rays (>= 99.95%), and each engine's
    ms for the wave;
13. gate ``wave_gate``: the per-wave path tracer at 320x180 and 2 spp, card
    against host CPU with the same keys, through the two-class gate;
14. ``scene_io``: ``save_scene`` / ``load_scene`` round trip of the scene
    through a temporary file, arrays bitwise equal;
15. ``cli``: the port's CLI in process, ``--synthetic battlefield --spp 4
    --profile --out pt.pfm`` (1280x720, ``PathTracingRenderer`` at the
    scene's depth 8, the default configuration): each frame's ms and
    Mrays/s from its ``RenderStats``, ``dropped`` (must be 0), the
    launches of K1, K2 and K3 over the render (each must be > 0) and over
    the ``--profile`` stage timing after it, the stage breakdown, the PFM
    (720 x 1280 x 3, finite, not black), the same render as PNG
    (signature and size), and a ``profile`` line of one more frame;
16. ``cli_resume``: at depth 2, ``--spp 4 --seed 5`` against ``--spp 2
    --seed 5 --checkpoint ck`` then ``--spp 4 --seed 999 --checkpoint
    ck``: the two PFMs must be bitwise equal;
17. ``cli_whitted``: ``--synthetic battlefield --whitted --spp 1`` (depth
    8): K1, K2 and K3 must launch, ``dropped`` 0;
18. ``viewer``: the live viewer on ``port=0`` in a thread, on the scene at
    320x180: ``/frame.png`` (PNG signature) and ``/stats`` once frames
    accumulate; ``/input?key=w`` must move the camera, reset the
    accumulation and let it grow again, then ms a frame over four steady
    frames; K1, K2 and K3 must launch;
19. slice ``mesh1``: BASELINE config 5b, ``PathTracingRenderer`` with
    ``Configuration(mesh_shape=(1,))`` at 1280x720, depth 2: the frame runs
    through the mesh code (``parallel/mesh.py``) under a one-rank NCCL
    group that ``create_context`` forms (its backend and world size are on
    the line); one warm-up and three timed frames; K1, K2 and K3 must
    launch, ``dropped`` 0;
20. gate ``mesh1_gate``: at 320x180, a one-rank mesh on the card against
    a one-rank mesh on the host CPU (gloo) with the same key, for
    ``PathTracingRenderer`` at depth 2 (K1, K2, K3 must launch) and for
    ``WhittedRenderer`` at depth 3 with shadows (K1-K4 must launch),
    through the two-class gate;
21. slice ``pt_default``: ``PathTracingRenderer`` with
    ``Configuration(precision="default")`` at 1280x720, depth 2, as
    ``pt``: the bf16 variants of K1 and K3 must launch and the fp32 forms
    must not, ``dropped`` 0;
22. ``default_gate``: at 1280x720, ``precision="default"`` against
    ``"highest"`` on the card with the same key, for
    ``PathTracingRenderer`` at depth 2 and ``WhittedRenderer`` at depth 3
    with shadows: ``rmse_trimmed`` and ``frac_flip`` reported with no bar
    (the one-pass bf16 product is another function, as on the TPU); the
    bf16 variants of K1, K3 and K4 must launch, the fp32 forms must not,
    ``dropped`` 0 on both sides;
23. ``whitted_scan``: ``WhittedRenderer`` with
    ``Configuration(hybrid_tracing=False, whitted_bounce_scan=65536)`` at
    depth 8 and 1280x720 (bounces on the dense engine, the widest stage
    traced in slices of 65,536 lanes): one warm-up and one timed frame,
    then the frame with ``whitted_bounce_scan=None`` and the same key;
    K1 must launch in the bounce loop and K2 and K3 not at all, the
    radiance must be within 2 ulp of the unscanned frame's and
    ``dropped`` (the dense queue's clamped clusters, expected non-zero)
    equal in the two;
24. slice ``whitted_shadow_default``: ``whitted_shadow`` (BASELINE config
    1) with ``Configuration(precision="default")``: the bf16 variants of
    K1 and K4 must launch and the fp32 forms must not, ``dropped`` 0, with
    its profiled frame and launch frame;
25. ``oracle``: ``tools/oracle_lib.py``'s ray sets (65,536 rays each:
    mid-frame primaries, scattered rays, and sky rays with no candidate
    pair) on the headline cluster scene, each cluster engine against
    ``mxu``: every row must pass the oracle bar; the launches of each set,
    and whether the sky set launched K2 and K3 or skipped them (either is
    allowed); K1-K4 must launch on the primaries, K2 and K3 on the
    scattered rays;
26. ``image_oracle``: ``run_image_oracle`` at 320x180, 2 spp, depth 2: the
    production frame against the lockstep-BVH ``xla`` engine on the card,
    ``rmse_trimmed < 1e-3``, ``frac_flip < 0.5%``, ``dropped`` 0, with
    each side's seconds;
27. ``bench``: ``python -m rayaccel_tpu_torch.bench`` in a subprocess with
    ``BENCH_ONLY=2,5`` and ``BENCH_FRAMES=2`` (the headline, the one-rank
    mesh and its group's teardown, and the dry run; the other configs are
    the slices above): exit 0, every line JSON, each config's metric once
    and none an error or skipped, ``dropped`` 0 on every line, the dry run
    ok, and the headline first and again last with a value above 0.

Each slice sets every launch count to 0 just before its timed frames and
reads them just after. After them, each slice renders two more frames:
one under ``torch.profiler`` (the ``profile`` line: device ms of each
kernel and of all kernels, and the device's idle share; a kernel the slice
must launch and whose device time reads 0 fails the run), and one in which
every kernel launch keeps a copy of its inputs; each launch is then timed
again alone at its own width and its bound taken from its own inputs (the
``launches`` line: per kernel, ms, bound ms and share summed over the
frame's launches, and the gap, ms - bound ms); ``pt_stratified`` renders
its timed frames only. Then the kernel table as
one JSON line (each row with its launches, ms, bound ms and gap per frame
of each slice from those lines), and last ``{"ok": true, "device":
{...}}``. A failing phase raises.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time


# The Whitted gate's viewport: its host-CPU side traces depth-8 trees with
# shadows through the plain versions.
WHITTED_GATE_VIEWPORT = (320, 180)

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): fp32
# outside the tensor cores, bf16 on the tensor cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations a kernel needs: 40 FMAs (80 FLOP) for the four bilinear
# dot products of one (ray, triangle) pair (K1, K3, K4), and ~24 for K2's
# slab test of one (lane, box).
FLOP_PER_TRIANGLE = 80
FLOP_PER_SLAB = 24
NO_LIBRARY = "none: no single PyTorch call computes it"
# The threefry kernel's bound: the operations only the INT32 pipe runs,
# 64 a clock on each of the 132 SMs (NVIDIA's documented throughput of
# 32-bit shifts and logic at compute capability 9.0), at 1.98 GHz: a
# Threefry-2x32 block's 20 rotations and 20 xors, a float's shift and or,
# and each xor of two words (the positional and pair draws); the pair's
# per-element key adds its schedule's xor. The adds are left out: the
# kernel's SASS (sm_90a) issues all but 8-15 of them a row as IMAD.IADD on
# the FMA pipe, and its SHF, LOP3 and LEA.HI come to 43, 83 and 126 a row.
PEAK_INT32_OPS = 132 * 64 * 1.98e9
THREEFRY_SHAPES = ("positional", "lane", "pair")     # rng.py's numbering
THREEFRY_ROW_OPS = (40 + 1 + 2, 2 * 40 + 3 * 2, 3 * 40 + 1 + 2 * (1 + 2))
# Rays of each of the oracle's ray sets (``tools/oracle_lib.py``'s).
ORACLE_RAYS = 65536
# The metrics of ``python -m rayaccel_tpu_torch.bench`` at
# ``BENCH_ONLY=2,5``, the headline first.
BENCH_ONLY = "2,5"
BENCH_HEADLINE = "pt_battlefield_mrays_per_s_per_chip"
BENCH_METRICS = (BENCH_HEADLINE, "multichip_mesh1_gpu_mrays_per_s",
                 "multichip_cpu_mesh_smoke")
# Each kernel's name in a profiler trace, a pattern (K2 has a kernel for
# the boxes one CTA holds and one that streams more); "_bf16" names the bf16
# tensor-core variant (precision "default") of K1, K3 and K4. K3's unit
# pass, which both of its forms run, is reported beside them.
KERNEL_SYMBOLS = {"dense_closest_hit": "dense_hit_kernel",
                  "dense_occluded": "dense_occl_kernel",
                  "select_nearest": r"\bselect_(chunks_)?kernel<",
                  "pair_hit": "pair_hit_kernel",
                  "dense_closest_hit_bf16": "dense_hit_bf16_kernel",
                  "dense_occluded_bf16": "dense_occl_bf16_kernel",
                  "pair_hit_bf16": "pair_hit_bf16_kernel",
                  "threefry_draws": r"\bthreefry_kernel<"}
UNIT_PASS_SYMBOL = "pair_hit_units_kernel"
BF16_KERNELS = ("dense_closest_hit", "dense_occluded", "pair_hit")


def row_name(name, precision):
    """The kernel-table row of a launch of wrapper ``name``."""
    return name + "_bf16" if precision == "default" else name


def peak_flops(precision):
    return PEAK_BF16_TENSOR_FLOPS if precision == "default" else PEAK_FP32_FLOPS


def emit(obj):
    print(json.dumps(obj), flush=True)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def roofline(flop, moved, ms, peak=PEAK_FP32_FLOPS):
    """The least time the card could take for ``flop`` operations at
    ``peak`` (fp32, or bf16 on the tensor cores for a bf16 variant) and
    ``moved`` bytes (each input read once, each output written once),
    which of the two binds, and the kernel's share of that bound. No
    single PyTorch call computes any of the four kernels, so there is no
    library time."""
    ops_ms = flop / peak * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    return dict(flop=flop, bytes=moved, ops_ms=ops_ms, bytes_ms=bytes_ms,
                bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                share_of_bound=bound_ms / ms, library_ms=None,
                library=NO_LIBRARY)


def queued(q_cluster, q_count):
    """(T, cap) bool: the distinct clusters of each tile's queue row (the
    padding that repeats the farthest cluster is no work)."""
    import torch
    pos = torch.arange(q_cluster.shape[1], device=q_cluster.device)
    new = torch.ones_like(q_cluster, dtype=torch.bool)
    new[:, 1:] = q_cluster[:, 1:] != q_cluster[:, :-1]
    return new & (pos[None, :] < q_count[:, None])


def cluster_bytes(G3, clusters):
    """Bytes of the G3 rows (or of another per-cluster layout, such as its
    bf16 fragment copy) of the distinct clusters named."""
    return clusters.unique().numel() * G3[0].numel() * G3.element_size()


def k1_pairs_needed(F, q_cluster, q_entry, q_count, best, tile):
    """(active ray, queued cluster) pairs whose entry is at most the ray's
    final packed best: the least any walk of these inputs tests."""
    T = q_cluster.shape[0]
    active = (F[:, 11] >= 0).view(T, tile, 1)
    near = q_entry[:, None, :] <= best.view(T, tile, 1)
    return int((queued(q_cluster, q_count)[:, None, :] & near
                & active).sum())


def k4_pairs_needed(dense, F, G3, q_cluster, q_entry, q_count, tile,
                    precision="highest"):
    """(active ray, queued cluster) pairs in queue order up to and
    including the ray's first blocker (at ``precision``), among the
    clusters whose entry is within its tmax."""
    import torch
    T = q_cluster.shape[0]
    Fm = F.view(T, tile, 16)
    tmin, tmax = Fm[:, :, 10:11], Fm[:, :, 11:12]
    t_bits = Fm[:, :, 11].contiguous().view(torch.int32)
    valid = queued(q_cluster, q_count)
    done = t_bits < 0                       # inactive rays need nothing
    needed = 0
    for j in range(int(q_count.max())):
        need = ~done & valid[:, j:j + 1] & (q_entry[:, j:j + 1] <= t_bits)
        needed += int(need.sum())
        inside, ad, ts = dense._candidates(Fm[:, :, :10], G3, q_cluster[:, j],
                                           precision)
        done |= need & (inside & (ts > ad * tmin)
                        & (ts <= ad * tmax)).any(dim=2)
    return needed


def k1_pairs_entered(dense, F, G3, q_cluster, q_entry, q_count, best, tile,
                     boxes):
    """(active ray, queued cluster) pairs whose box the ray itself enters
    no later than its final packed best: the least a walk that takes a
    ray's candidates only from the boxes it enters tests."""
    import torch
    T = q_cluster.shape[0]
    Fm = F.view(T, tile, 16)
    inv = dense.safe_inv_dir(Fm[:, :, 0:3])
    valid = queued(q_cluster, q_count)
    best = best.view(T, tile)
    active = Fm[:, :, 11] >= 0
    pairs = 0
    for j in range(int(q_count.max())):
        cl = q_cluster[:, j].long()
        t0, t1 = dense._slab(Fm[:, :, 3:6], inv, Fm[:, :, 10], Fm[:, :, 11],
                             boxes[0][cl][:, None], boxes[1][cl][:, None])
        entry = (torch.clamp_min(t0, 0.0) + 0.0).view(torch.int32)
        pairs += int((valid[:, j:j + 1] & active & (t0 <= t1)
                      & (entry <= best)).sum())
    return pairs


def walk_counts(fn, args, q_count, tile, **kw):
    """What the gate of a dense kernel's walk saves on ``args``: the pairs
    its warps walked and the clusters its CTAs staged (its ``walked=``
    counter), beside the tile walk's rays x queue length and CTAs x queue
    length."""
    from rayaccel_tpu_torch.ops.trace_dense import CTA_RAYS
    rows = int(q_count.sum())
    walked, staged = counted(fn, args, "walked", 2, **kw)
    return dict(pairs_walked=walked, pairs_tile_walk=tile * rows,
                clusters_staged=staged,
                clusters_tile_walk=tile // CTA_RAYS * rows)


def counted(fn, args, name, n, **kw):
    """The ``n`` counters a kernel adds to its ``name=`` tensor in one
    launch on ``args`` (and ``kw``): the pairs a dense kernel's warps
    ``walked``, the lanes K2 ``tested``, K3's ``stats``."""
    import torch
    count = torch.zeros(n, dtype=torch.int64, device=args[0].device)
    fn(*args, **{name: count}, **kw)
    return count.tolist()


def record_launches(dense, sparse, run):
    """Run ``run()`` with every kernel wrapper replaced by one that keeps a
    copy of its inputs and its output. Returns [(wrapper, args, kwargs,
    out)] in launch order."""
    import torch
    from rayaccel_tpu_torch import rng
    calls = []

    def keeper(fn):
        # A wrapper counts its launches on its module's name, which is
        # the keeper's while ``run`` runs.
        def keep(*a, **kw):
            a = tuple(x.clone() if torch.is_tensor(x) else x for x in a)
            before = keep.launches
            out = fn(*a, **kw)
            if keep.launches > before:         # K3 skips an empty pass
                calls.append((fn, a, kw, out))
            return out
        keep.launches = keep.guard_launches = keep.launches_bf16 = 0
        return keep

    originals = {}
    for mod, fn in ((dense, dense.dense_closest_hit),
                    (dense, dense.dense_occluded),
                    (sparse, sparse.select_nearest),
                    (sparse, sparse.pair_hit),
                    (rng, rng.threefry_draws)):
        originals[fn.__name__] = (mod, fn)
        setattr(mod, fn.__name__, keeper(fn))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for fname, (mod, fn) in originals.items():
            setattr(mod, fname, fn)
    return calls


def kernel_work(dense, name, args, out, n_c, precision="highest"):
    """(operations, bytes) that one launch of a kernel needs on its own
    inputs ``args`` and output ``out`` at ``precision``: K1 and K4 their
    pairs needed, K2 its live lanes (tmax > 0) against the n_c real boxes
    (the padding boxes are no work), K3 the pairs its items cover, the
    threefry draws ``THREEFRY_ROW_OPS`` a row."""
    if name == "threefry_draws":
        shape, _, ids, n = args[:4]
        return (n * THREEFRY_ROW_OPS[shape],
                nbytes(out) + (0 if ids is None else nbytes(ids)))
    if name in ("dense_closest_hit", "dense_occluded"):
        F, G3, qc, qe, qn, tile = args[:6]
        pairs = (k1_pairs_needed(F, qc, qe, qn, out[0], tile)
                 if name == "dense_closest_hit" else
                 k4_pairs_needed(dense, F, G3, qc, qe, qn, tile, precision))
        return (pairs * (G3.shape[1] // 4) * FLOP_PER_TRIANGLE,
                nbytes(F, qc, qe, qn, out)
                + cluster_bytes(G3, qc[queued(qc, qn)]))
    if name == "select_nearest":
        F8, prev, live, bb = args[:4]
        return (int((F8[:, 7] > 0).sum()) * n_c * FLOP_PER_SLAB,
                nbytes(F8, prev, live, bb, out))
    Fp, G3, items = args[:3]
    pairs = int((items[:, 1] - items[:, 0]).sum())
    return (pairs * (G3.shape[1] // 4) * FLOP_PER_TRIANGLE,
            nbytes(Fp, items, out) + cluster_bytes(G3, items[:, 2]))


def queue_words_differing(got, want):
    """Words of a queue (q_cluster, q_entry, q_count, overflow) that differ
    from another's, an entry of -0.0 read as +0.0."""
    plain_entry = want[1].masked_fill(want[1] == -0x80000000, 0)
    return (int((got[0] != want[0]).sum())
            + int((got[1] != plain_entry).sum())
            + int((got[2] != want[2]).sum()) + int(got[3] != want[3]))


def kernel_row(s):
    """A kernel phase's times and bound, as the kernel table carries them."""
    return {k: s[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "share_of_bound", "library_ms", "library")}


def hit_stats(hit_a, hit_b, win_a, win_b, t_a, t_b):
    """Oracle-table agreement between two traces of the same rays."""
    import torch
    both = hit_a & hit_b
    rel = ((t_a - t_b).abs() / t_b.abs().clamp_min(1e-6))[both]
    return dict(
        n=int(hit_a.numel()), hits=int(hit_a.sum()),
        hit_agree=float((hit_a == hit_b).float().mean()),
        winner_agree=float((win_a == win_b)[both].float().mean())
        if both.any() else 1.0,
        t_within_1e3=float((rel < 1e-3).float().mean()) if both.any() else 1.0,
        max_rel_t=float(rel.max()) if both.any() else 0.0,
        max_abs_t=float((t_a - t_b).abs()[both].max()) if both.any() else 0.0)


def check_bench(rc, lines):
    """Raise unless ``python -m rayaccel_tpu_torch.bench`` with
    ``BENCH_ONLY=2,5`` exited 0 with its contract: the knobs line,
    each config's metric once and none an error or skipped, every
    ``dropped`` 0, the dry run ok, and the headline again last with a
    positive value."""
    metrics = [ln["metric"] for ln in lines[1:-1]]
    bad = [ln for ln in lines[1:]
           if ln.get("unit") in ("error", "skipped_deadline")
           or ln.get("dropped") != 0]
    smoke = [ln for ln in lines if ln["metric"] == "multichip_cpu_mesh_smoke"]
    if not (rc == 0 and lines and lines[0]["metric"] == "bench_knobs"
            and sorted(metrics) == sorted(BENCH_METRICS) and not bad
            and lines[-1] == lines[1]
            and lines[-1]["metric"] == BENCH_HEADLINE
            and lines[-1]["value"] > 0 and smoke[0]["value"] == 1):
        raise AssertionError(f"bench failed (rc {rc}): {lines}")


def check_mb(exact, timing, k3, C, shape):
    """P4's run (``tools/probe_pair_dma.py:run``) at one shape: no word
    differs from K3's at any ring depth, the kernel's counters equal the
    plan's, and where its CTAs are K3's (the same grid) it staged K3's
    clusters (``k3``: K3's kernel line), 48 bytes a G3 row."""
    bad = [S for S, n in exact["n_diff_by_stages"].items() if n]
    bad += [S for S, ok in exact["counters_equal_plan"].items() if not ok]
    for S, got in timing["counters"].items():
        if got["ctas"] == k3["ctas"] and (got["bytes_staged"] != k3[
                "clusters_staged"] * 4 * C * 48):
            bad.append(S)
    if bad:
        raise AssertionError(f"P4 at the {shape} shape failed at ring depths "
                             f"{sorted(set(bad))}: {exact} {timing}")


def read_pfm(path):
    """(H, W, 3) float32 of a PFM file (bottom-up rows, little-endian)."""
    import numpy as np
    with open(path, "rb") as f:
        if f.readline().strip() != b"PF":
            raise AssertionError(f"{path} is not a colour PFM")
        w, h = map(int, f.readline().split())
        f.readline()
        return np.flipud(np.fromfile(f, np.float32).reshape(h, w, 3))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.distributed as dist
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.ops import _kernels
    from rayaccel_tpu_torch.ops import trace_dense as dense
    from rayaccel_tpu_torch.ops import trace_sparse as sparse
    from rayaccel_tpu_torch.ops.bruteforce import trace_bruteforce
    from rayaccel_tpu_torch.ops.intersect import safe_inv_dir
    from rayaccel_tpu_torch.ops.trace import trace_bvh, trace_occlusion_bvh
    from rayaccel_tpu_torch.ops.trace_mxu import (trace_mxu,
                                                  trace_occlusion_mxu)
    from rayaccel_tpu_torch.render import pathtracer, whitted
    from rayaccel_tpu_torch.render.shading import surface_from_attrs
    from rayaccel_tpu_torch.scene.clusters import (SELECT_CHUNK,
                                                   cluster_scene_from_numpy,
                                                   compile_clusters,
                                                   compile_clusters_np)
    from rayaccel_tpu_torch.scene.data import SceneData
    from rayaccel_tpu_torch.scene.compile import compile_scene
    from rayaccel_tpu_torch.scene.loader import (load_scene,
                                                 make_battlefield_like,
                                                 save_scene)
    from rayaccel_tpu_torch import cli as racc_cli
    from rayaccel_tpu_torch.tools import oracle_lib, probe_dma, probe_pair_dma
    from rayaccel_tpu_torch.tools.oracle_lib import (require_oracle_bar,
                                                     two_class_gate)
    from rayaccel_tpu_torch.utils import image, profiling
    from rayaccel_tpu_torch.utils.profiling import cuda_ms
    from rayaccel_tpu_torch.utils.viewer import Viewer
    from rtbench.scenes import spd_tetra

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device ----
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(dict(phase="device", kind=kind, nvidia_smi=smi,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))

    # ---- 2. build ----
    t0 = time.perf_counter()
    _kernels.library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              ptxas=[ln.strip() for ln in _kernels.build_log.splitlines()
                     if "registers" in ln or "spill" in ln]))

    # ---- 3. kernels against their plain versions ----
    t0 = time.perf_counter()
    sd = make_battlefield_like(max_depth=2)
    arrays = compile_clusters_np(sd)
    cs = cluster_scene_from_numpy(**arrays, device=dev)
    ctx = racc.create_context(racc.default_configuration(), device=dev)
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, sd.viewport_width,
                              sd.viewport_height)
    renderer = racc.PathTracingRenderer(ctx, cam, sd, tpu_scene=cs)
    opts = ctx.configuration.engine_opts()
    emit(dict(phase="scene", seconds=time.perf_counter() - t0,
              triangles=sd.triangle_count, clusters=cs.n_clusters,
              cluster_size=cs.cluster_size, lanes=renderer.n_lanes,
              waves=renderer.n_waves, wave_size=renderer.wave_size))
    key = rng.PRNGKey(1)
    cam_arrays = cam.as_arrays(dev)
    tile = renderer.tile
    kernels = []

    # K1: one primary wave from the middle of the frame (the top waves
    # are sky).
    w = renderer.n_waves // 2
    rays = pathtracer._primary_rays(cam_arrays, renderer._wave_x[w],
                                    renderer._wave_y[w], rng.fold_in(key, w))
    active = renderer._wave_alive[w]
    R = rays.o.shape[0]
    T = R // tile
    F, *q = dense._dense_inputs(cs, rays, active, tile, opts.k_step,
                                opts.tile_cap)
    args = (F, cs.G3, q[0], q[1], q[2], tile, opts.k_step)
    kb = dict(boxes=dense.cluster_boxes(cs))
    out_k = dense.dense_closest_hit(*args, **kb)
    out_p = dense.dense_closest_hit_plain(*args, **kb)
    torch.cuda.synchronize()

    def winner_t(slot, scene=cs, on=rays):
        hit = slot >= 0
        _, _, t, _, _ = dense.reconstruct(scene, on,
                                          torch.where(hit, slot, 0))
        return hit, t

    hk, tk = winner_t(out_k[1])
    hp, tp = winner_t(out_p[1])
    s1 = hit_stats(hk, hp, out_k[1], out_p[1], tk, tp)
    # The pairs needed are counted from the plain version's bests.
    flop, moved = kernel_work(dense, "dense_closest_hit", args, out_p,
                              cs.n_clusters)
    s1.update(queue_overflow=int(q[3]), queue_max=int(q[2].max()),
              words_differing=int((out_k != out_p).sum()),
              ctas=R // dense.CTA_RAYS,
              pairs_needed=flop // (cs.cluster_size * FLOP_PER_TRIANGLE),
              pairs_entered=k1_pairs_entered(dense, *args[:5], out_p[0],
                                             tile, **kb),
              **walk_counts(dense.dense_closest_hit, args, q[2], tile, **kb),
              ms=cuda_ms(lambda: dense.dense_closest_hit(*args, **kb), 20),
              plain_ms=cuda_ms(
                  lambda: dense.dense_closest_hit_plain(*args, **kb), 3))
    s1.update(roofline(flop, moved, s1["ms"]))
    emit(dict(phase="kernel", name="K1 dense_closest_hit", rays=R,
              tiles=T, **s1))
    require_oracle_bar("K1", s1)
    kernels.append(dict(name="dense_closest_hit", route="cuda",
                        source="rayaccel_tpu_torch/csrc/dense_hit.cu",
                        replaces="rayaccel_tpu/ops/trace_pallas.py:77",
                        max_abs_err=s1["max_abs_t"],
                        **kernel_row(s1)))

    # The bf16 variants (precision "default") on the inputs of the fp32
    # lines, each against its plain version at "default"; their rows
    # follow the four fp32 ones in the kernel table.
    bf16_rows = []
    default = dict(precision="default")
    kernel_default = dict(default, G3b=cs.G3b)
    dense_default = dict(kernel_default, **kb)
    plain_default = dict(default, group=dense.BF16_WARP_RAYS, **kb)
    out_b = dense.dense_closest_hit(*args, **dense_default)
    out_bp = dense.dense_closest_hit_plain(*args, **plain_default)
    torch.cuda.synchronize()
    hb, tb = winner_t(out_b[1])
    hbp, tbp = winner_t(out_bp[1])
    s1b = hit_stats(hb, hbp, out_b[1], out_bp[1], tb, tbp)
    vs = hit_stats(hb, hk, out_b[1], out_k[1], tb, tk)
    flop, moved = kernel_work(dense, "dense_closest_hit", args, out_bp,
                              cs.n_clusters, "default")
    s1b.update(words_differing=int((out_b != out_bp).sum()),
               ctas=R // dense.CTA_RAYS,
               staged_bytes=cluster_bytes(cs.G3b, q[0][queued(q[0], q[2])]),
               pairs_needed=flop // (cs.cluster_size * FLOP_PER_TRIANGLE),
               **walk_counts(dense.dense_closest_hit, args, q[2], tile,
                             **dense_default),
               vs_fp32={k: vs[k] for k in ("hit_agree", "winner_agree",
                                           "t_within_1e3")},
               ms=cuda_ms(lambda: dense.dense_closest_hit(
                   *args, **dense_default), 20),
               plain_ms=cuda_ms(lambda: dense.dense_closest_hit_plain(
                   *args, **plain_default), 3))
    s1b.update(roofline(flop, moved, s1b["ms"], PEAK_BF16_TENSOR_FLOPS))
    emit(dict(phase="kernel", name="K1 dense_closest_hit bf16", rays=R,
              tiles=T, **s1b))
    require_oracle_bar("K1 bf16", s1b)
    bf16_rows.append(dict(name="dense_closest_hit_bf16", route="cuda",
                          source="rayaccel_tpu_torch/csrc/dense_hit.cu",
                          replaces="rayaccel_tpu/ops/trace_pallas.py:77",
                          max_abs_err=s1b["max_abs_t"], **kernel_row(s1b)))
    del out_b, out_bp

    # The 983,040-lane bounce pool: stage 1 of a frame.
    state, _ = pathtracer._stage1(cs, cam_arrays, renderer._wave_x,
                                  renderer._wave_y, renderer._wave_alive, key,
                                  2, "pallas", tile, opts)
    pool = state["rays"]
    N = pool.o.shape[0]
    pool_tmax = torch.where(state["alive"], pool.tmax,
                            torch.full_like(pool.tmax, -1))
    pool_inv = safe_inv_dir(pool.d)
    n_cp = cs.bb.shape[0]
    id_bits = max((n_cp - 1).bit_length(), 1)
    sel_tile = sparse._select_tile(N, n_cp)
    live = ((pool_tmax > 0).reshape(-1, sel_tile).any(dim=1)
            .repeat_interleave(sel_tile).to(torch.uint8))
    F8 = torch.cat([pool.o, pool_inv, pool.tmin[:, None],
                    pool_tmax[:, None]], dim=1)
    prev = torch.full((N,), -0x80000000, dtype=torch.int32, device=dev)
    k2 = {}
    spill4 = None
    for k in (opts.k_pairs, opts.k_restart):
        pv = prev if spill4 is None else spill4
        a = (F8, pv, live, cs.bb, k, id_bits)
        sel_k = sparse.select_nearest(*a)
        sel_p = sparse.select_nearest_plain(*a)
        torch.cuda.synchronize()
        equal = bool(torch.equal(sel_k, sel_p))
        max_diff = int((sel_k.long() - sel_p.long()).abs().max())
        ms = cuda_ms(lambda: sparse.select_nearest(*a), 10)
        plain_ms = cuda_ms(lambda: sparse.select_nearest_plain(*a), 2)
        s2 = dict(k=k, lanes=N, live_lanes=int(state["alive"].sum()),
                  lanes_tested=counted(sparse.select_nearest, a, "tested",
                                       1)[0],
                  split=sparse.select_split(N),
                  boxes=cs.n_clusters, padded_boxes=n_cp,
                  bitwise_equal=equal,
                  words_differing=int((sel_k != sel_p).sum()),
                  pairs=int((sel_k[:k] < 0x7F800000).sum()),
                  ms=ms, plain_ms=plain_ms)
        # The slab tests the live lanes need, against every real box.
        s2.update(roofline(*kernel_work(dense, "select_nearest", a, sel_k,
                                        cs.n_clusters), ms))
        emit(dict(phase="kernel", name="K2 select_nearest", **s2))
        if not equal:
            raise AssertionError(f"K2 (k={k}) differs from its plain version")
        if spill4 is None:
            spill4 = sel_k[k].contiguous()
            lat = sel_k[:k]
            k2.update(max_abs_err=max_diff, **kernel_row(s2))
            k2_pairs_per_ms = N * cs.n_clusters / ms
    kernels.append(dict(name="select_nearest", route="cuda",
                        source="rayaccel_tpu_torch/csrc/select_nearest.cu",
                        replaces="rayaccel_tpu/ops/trace_sparse.py:209",
                        **k2))

    # The dense cull and queue of K1's wave: the kernel against its plain
    # version, and its time beside the bound and beside K2's pair rate.
    a0 = (cs, rays.o, safe_inv_dir(rays.d), rays.tmin,
          torch.where(active, rays.tmax, torch.full_like(rays.tmax, -1.0)),
          T, tile, opts.k_step, opts.tile_cap)
    q_k = dense.cull_and_queue(*a0)
    q_p = dense.cull_and_queue_plain(*a0)
    torch.cuda.synchronize()
    pairs = R * cs.n_clusters
    s0 = dict(rays=R, tiles=T, tile=tile, clusters=cs.n_clusters,
              pairs=pairs, words_differing=queue_words_differing(q_k, q_p),
              queue_max=int(q_k[2].max()), queue_overflow=int(q_k[3]),
              ms=cuda_ms(lambda: dense.cull_and_queue(*a0), 20),
              plain_ms=cuda_ms(lambda: dense.cull_and_queue_plain(*a0), 3),
              k2_rate_ms=pairs / k2_pairs_per_ms)
    s0.update(roofline(pairs * FLOP_PER_SLAB, nbytes(*a0[1:5], cs.cl_bbmin,
                                                     cs.cl_bbmax, *q_k),
                       s0["ms"]))
    emit(dict(phase="kernel", name="cull_and_queue", **s0))
    if s0["words_differing"]:
        raise AssertionError(f"the cull and queue differ from their plain "
                             f"version: {s0}")

    # K3: pass 1 of the first bounce (the pool's k = 4 lattice).
    K = opts.k_pairs
    SP = opts.sp_tile
    cap = min(max(SP, -(-opts.pair_budget * N // SP) * SP),
              -(-K * N // SP) * SP)
    cl, ray, rank, total = sparse._lattice_pairs(
        lat < 0x7F800000, lat & ((1 << id_bits) - 1), cap)
    Fp, items = sparse._pair_inputs(pool.o, pool.d, pool.tmin, pool_tmax,
                                    cl, ray, rank, SP)
    col_bits = max((cs.cluster_size - 1).bit_length(), 1)
    a3 = (Fp, cs.G3, items, col_bits, False)
    pk = sparse.pair_hit(*a3)
    pp = sparse.pair_hit_plain(*a3)
    torch.cuda.synchronize()
    low = (1 << (col_bits + 3)) - 1

    def per_ray(packed):
        """Per-ray merge and the winner's exact t, as trace_sparse does."""
        best = torch.full((N,), 0x7F000000, dtype=torch.int32, device=dev)
        best.scatter_reduce_(0, ray, packed, "amin")
        hit = best < 0x7F000000
        rank_w = (best >> col_bits) & 7
        ksel = torch.arange(K, device=dev)[:, None] == rank_w[None, :]
        cluster = torch.where(ksel, lat & ((1 << id_bits) - 1), 0).sum(0)
        slot = cluster * cs.cluster_size + (best & ((1 << col_bits) - 1))
        _, _, t, _, _ = dense.reconstruct(cs, pool, torch.where(hit, slot, 0))
        return hit, best & low, t

    s3 = hit_stats(*(x for pair in zip(per_ray(pk), per_ray(pp))
                     for x in pair))
    s3.update(pairs=int(cl.numel()), lattice_pairs=int(total),
              items=int(items.shape[0]),
              words_differing=int((pk != pp).sum()),
              **dict(zip(("units", "ctas", "clusters_staged"),
                         counted(sparse.pair_hit, a3, "stats", 3))),
              ms=cuda_ms(lambda: sparse.pair_hit(*a3), 10),
              plain_ms=cuda_ms(lambda: sparse.pair_hit_plain(*a3), 2))
    s3.update(roofline(*kernel_work(dense, "pair_hit", a3, pk,
                                    cs.n_clusters), s3["ms"]))
    emit(dict(phase="kernel", name="K3 pair_hit", **s3))
    require_oracle_bar("K3", s3)
    kernels.append(dict(name="pair_hit", route="cuda",
                        source="rayaccel_tpu_torch/csrc/pair_hit.cu",
                        replaces="rayaccel_tpu/ops/trace_sparse.py:77",
                        max_abs_err=s3["max_abs_t"], **kernel_row(s3)))

    # The probes, P1-P3 (tools/probe_dma.py) and P4 (tools/probe_pair_dma.py,
    # on K3's inputs): first their own path, the entry points' runs, with
    # their launch counts set to 0 just before and read just after; then
    # each kernel against its plain version on the same inputs.
    probe_fns = (probe_dma.copy_static, probe_dma.copy_dynamic,
                 probe_dma.copy_worklist, probe_pair_dma.pair_hit_mb)
    for fn in probe_fns:
        fn.launches = 0
    dma_lines = probe_dma.run(dev)
    exact, timing = probe_pair_dma.run(*a3[:4])
    probe_launches = {fn.__name__: fn.launches for fn in probe_fns}
    if not (all(ln["ok"] for ln in dma_lines)
            and min(probe_launches.values()) > 0):
        raise AssertionError(f"probes failed: {dma_lines} {probe_launches}")
    check_mb(exact, timing, s3, cs.cluster_size, "headline")
    probe_rows, steps = [], []
    for (step, fn, fargs, _, text), line, line_no in zip(
            probe_dma.steps(probe_dma.probe_input(dev)), dma_lines,
            (33, 57, 88)):
        plain = getattr(probe_dma, fn.__name__ + "_plain")
        got, want = fn(*fargs), plain(*fargs)
        torch.cuda.synchronize()
        # Bytes: each block read, the output written, the index list read.
        blocks = fargs[1].numel() if step == "C" else 1
        flop = blocks * got.numel() if step == "C" else 0
        ps = dict(step=step, bitwise_equal=bool(torch.equal(
                      got.view(torch.int32), want.view(torch.int32))),
                  ms=line["kernel_us"] / 1e3,
                  plain_ms=cuda_ms(lambda: plain(*fargs), 100))
        ps.update(roofline(flop, (blocks + 1) * nbytes(got)
                           + nbytes(*fargs[1:]), ps["ms"]))
        ps.update(library_ms=line["library_us"] / 1e3, library=text)
        if step == "C":
            # P3's stages: the host's plan, a copy a stage issued before
            # any wait.
            ps.update(stages=line["plan"]["stages"])
        steps.append(dict(name=fn.__name__, **ps))
        if not ps["bitwise_equal"]:
            raise AssertionError(f"{fn.__name__} differs from its plain "
                                 f"version: {ps}")
        probe_rows.append(dict(
            name=fn.__name__, route="cuda",
            source="rayaccel_tpu_torch/csrc/probe_dma.cu",
            replaces=f"tools/probe_dma.py:{line_no}",
            launches=probe_launches[fn.__name__],
            max_abs_err=float((got - want).abs().max()), **kernel_row(ps)))
    mb = probe_pair_dma.pair_hit_mb(*a3)
    torch.cuda.synchronize()
    live = sparse.covered_pairs(Fp, items)[0]
    s_mb = hit_stats(*(x for pair in zip(per_ray(mb), per_ray(pp))
                       for x in pair))
    s_mb.update(live_pairs=int(live.sum()),
                words_differing_k3=int(((mb != pk) & live).sum()),
                words_differing=int((mb != pp).sum()),
                stages=timing["stages"], counters=timing["counters"],
                plan=timing["plan"], k3_counters=timing["k3_counters"],
                ms=timing["mb_ms"], k3_ms=timing["base_ms"],
                mb_ms_by_stages=timing["mb_ms_by_stages"],
                plain_ms=cuda_ms(
                    lambda: probe_pair_dma.pair_hit_mb_plain(*a3, sp=SP),
                    1))
    s_mb.update(roofline(*kernel_work(dense, "pair_hit", a3, mb,
                                      cs.n_clusters), s_mb["ms"]))
    emit(dict(phase="probes", launches=probe_launches, steps=steps,
              mb_exactness=exact, pair_hit_mb=s_mb))
    require_oracle_bar("P4", s_mb)
    if s_mb["words_differing_k3"]:
        raise AssertionError(f"P4 differs from K3: {s_mb}")
    probe_rows.append(dict(
        name="pair_hit_mb", route="cuda",
        source="rayaccel_tpu_torch/csrc/pair_hit_mb.cu",
        replaces="tools/probe_pair_dma.py:63",
        launches=probe_launches["pair_hit_mb"],
        max_abs_err=s_mb["max_abs_t"], stages=s_mb["stages"],
        k3_ms=s_mb["k3_ms"], mb_ms_by_stages=s_mb["mb_ms_by_stages"],
        **kernel_row(s_mb)))
    del mb, live

    pk_b = sparse.pair_hit(*a3, **kernel_default)
    pp_b = sparse.pair_hit_plain(*a3, **default)
    torch.cuda.synchronize()
    s3b = hit_stats(*(x for pair in zip(per_ray(pk_b), per_ray(pp_b))
                      for x in pair))
    vs = hit_stats(*(x for pair in zip(per_ray(pk_b), per_ray(pk))
                     for x in pair))
    s3b.update(pairs=int(cl.numel()), items=int(items.shape[0]),
               words_differing=int((pk_b != pp_b).sum()),
               staged_bytes=cluster_bytes(cs.G3b, items[:, 2]),
               **dict(zip(("units", "ctas", "clusters_staged"),
                          counted(sparse.pair_hit, a3, "stats", 3,
                                  **kernel_default))),
               vs_fp32={k: vs[k] for k in ("hit_agree", "winner_agree",
                                           "t_within_1e3")},
               ms=cuda_ms(lambda: sparse.pair_hit(*a3, **kernel_default), 10),
               plain_ms=cuda_ms(lambda: sparse.pair_hit_plain(*a3, **default),
                                2))
    s3b.update(roofline(*kernel_work(dense, "pair_hit", a3, pk_b,
                                     cs.n_clusters), s3b["ms"],
                        PEAK_BF16_TENSOR_FLOPS))
    emit(dict(phase="kernel", name="K3 pair_hit bf16", **s3b))
    require_oracle_bar("K3 bf16", s3b)
    if s3b["units"] != s3["units"]:
        raise AssertionError(f"K3 bf16 took {s3b['units']} work units, the "
                             f"fp32 form {s3['units']}")
    bf16_rows.append(dict(name="pair_hit_bf16", route="cuda",
                          source="rayaccel_tpu_torch/csrc/pair_hit.cu",
                          replaces="rayaccel_tpu/ops/trace_sparse.py:77",
                          max_abs_err=s3b["max_abs_t"], **kernel_row(s3b)))
    del pk_b, pp_b

    # K2 and K3 at a narrow shape: the first restart pass of that bounce,
    # as trace_sparse launches it (the compacted unresolved rays at their
    # ladder width, their spill words as prev, dead padding lanes, and
    # runs of a few pairs each).
    calls = record_launches(dense, sparse, lambda: sparse.trace_sparse(
        cs, pool, active=state["alive"], k_pairs=opts.k_pairs,
        pair_budget=opts.pair_budget, sp_tile=opts.sp_tile,
        max_passes=opts.max_passes, k_first=opts.k_first,
        k_restart=opts.k_restart))
    narrow = {}
    for fn, a, _, _ in calls:
        narrow.setdefault(fn.__name__, []).append(a)
    if min(len(narrow.get(n, ())) for n in ("select_nearest",
                                            "pair_hit")) < 2:
        raise AssertionError("the first bounce ran no restart pass")
    a = narrow["select_nearest"][1]
    sel_k = sparse.select_nearest(*a)
    sel_p = sparse.select_nearest_plain(*a)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: sparse.select_nearest(*a), 20)
    s2 = dict(k=a[4], lanes=int(a[0].shape[0]),
              live_lanes=int((a[0][:, 7] > 0).sum()),
              lanes_tested=counted(sparse.select_nearest, a, "tested", 1)[0],
              split=sparse.select_split(int(a[0].shape[0])),
              prev_words=int((a[1] > -0x80000000).sum()),
              bitwise_equal=bool(torch.equal(sel_k, sel_p)),
              words_differing=int((sel_k != sel_p).sum()), ms=ms,
              plain_ms=cuda_ms(lambda: sparse.select_nearest_plain(*a), 2))
    s2.update(roofline(*kernel_work(dense, "select_nearest", a, sel_k,
                                    cs.n_clusters), ms))
    # The same launch with each split forced, beside the launcher's choice.
    s2["ms_by_split"] = {
        S: cuda_ms(lambda: sparse._launch_select(*a, S, None), 20)
        for S in (1, 2, 4, 8, 16, 32)}
    emit(dict(phase="kernel", name="K2 select_nearest narrow", **s2))
    narrow_keys = ("ms", "bound_ms", "share_of_bound")
    kernels[-2]["narrow"] = dict(lanes=s2["lanes"],
                                 **{k: s2[k] for k in narrow_keys})
    if not s2["bitwise_equal"]:
        raise AssertionError("K2 differs from its plain version at the "
                             "narrow shape")
    if not 0 < s2["live_lanes"] <= s2["lanes_tested"] < s2["lanes"]:
        raise AssertionError(f"K2's narrow shape has no dead lane or "
                             f"tested too few: {s2}")

    # K3 and its bf16 variant at the narrow shape, each beside its row.
    a = narrow["pair_hit"][1]
    run_len = (a[2][:, 1] - a[2][:, 0]).float()
    units = []
    for name, row, kw, plain_kw, peak in (
            ("K3 pair_hit narrow", kernels[-1], {}, {}, PEAK_FP32_FLOPS),
            ("K3 pair_hit bf16 narrow", bf16_rows[-1], kernel_default,
             default, PEAK_BF16_TENSOR_FLOPS)):
        pk = sparse.pair_hit(*a, **kw)
        pp = sparse.pair_hit_plain(*a, **plain_kw)
        torch.cuda.synchronize()
        s3 = hit_stats(pk < 0x7F000000, pp < 0x7F000000, pk & low, pp & low,
                       (pk & ~low).view(torch.float32),
                       (pp & ~low).view(torch.float32))
        s3.update(pairs=int(a[0].shape[0]), items=int(a[2].shape[0]),
                  mean_run=float(run_len.mean()), max_run=int(run_len.max()),
                  words_differing=int((pk != pp).sum()),
                  **dict(zip(("units", "ctas", "clusters_staged"),
                             counted(sparse.pair_hit, a, "stats", 3, **kw))),
                  ms=cuda_ms(lambda: sparse.pair_hit(*a, **kw), 20),
                  plain_ms=cuda_ms(
                      lambda: sparse.pair_hit_plain(*a, **plain_kw), 2))
        if kw:
            s3["staged_bytes"] = cluster_bytes(cs.G3b, a[2][:, 2])
        s3.update(roofline(*kernel_work(dense, "pair_hit", a, pk,
                                        cs.n_clusters), s3["ms"], peak))
        emit(dict(phase="kernel", name=name, **s3))
        if not kw:
            k3_narrow = s3
        row["narrow"] = dict(pairs=s3["pairs"],
                             **{k: s3[k] for k in narrow_keys})
        require_oracle_bar(name, s3)
        units.append(s3["units"])
    if units[0] != units[1]:
        raise AssertionError(f"K3 bf16 took {units[1]} work units at the "
                             f"narrow shape, the fp32 form {units[0]}")
    # P4 at the narrow shape, every ring depth beside K3 (timed first and
    # last), its counters against the plan's.
    exact, timing = probe_pair_dma.run(*a[:4])
    check_mb(exact, timing, k3_narrow, cs.cluster_size, "narrow")
    mb = probe_pair_dma.pair_hit_mb(*a[:4], False)
    s_mb = dict(pairs=int(a[0].shape[0]), items=int(a[2].shape[0]),
                live_pairs=exact["n"], stages=timing["stages"],
                counters=timing["counters"], plan=timing["plan"],
                k3_counters=timing["k3_counters"], ms=timing["mb_ms"],
                k3_ms=timing["base_ms"],
                mb_ms_by_stages=timing["mb_ms_by_stages"])
    s_mb.update(roofline(*kernel_work(dense, "pair_hit", a, mb,
                                      cs.n_clusters), s_mb["ms"]))
    emit(dict(phase="probes", name="P4 pair_hit_mb narrow",
              mb_exactness=exact, pair_hit_mb=s_mb))
    probe_rows[-1]["narrow"] = dict(
        pairs=s_mb["pairs"], k3_ms=s_mb["k3_ms"],
        mb_ms_by_stages=s_mb["mb_ms_by_stages"],
        **{k: s_mb[k] for k in narrow_keys})
    del mb
    del state, pool, F8, Fp, items, sel_k, sel_p, pk, pp, calls, narrow, a

    # K4: the shadow rays of K1's wave, built from its hits as the Whitted
    # step builds them (every hit of a depth-1 frame casts one).
    hit = out_k[1] >= 0
    attr, tri, t, u, v = dense.reconstruct(cs, rays,
                                           torch.where(hit, out_k[1], 0))
    surf = surface_from_attrs(attr, cs.mat_params, rays,
                              dense.make_hits(rays, hit, tri, t, u, v))
    s_active = active & hit
    F4, q4c, q4e, q4n, ov4 = dense._dense_inputs(
        cs, whitted.shadow_rays(surf), s_active, tile, opts.k_step,
        opts.tile_cap)
    a4 = (F4, cs.G3, q4c, q4e, q4n, tile, opts.k_step)
    occ_k = dense.dense_occluded(*a4, **kb)
    occ_p = dense.dense_occluded_plain(*a4, **kb)
    torch.cuda.synchronize()
    flop, moved = kernel_work(dense, "dense_occluded", a4, occ_k,
                              cs.n_clusters)
    s4 = dict(shadow_rays=int(s_active.sum()), occluded=int(occ_k.sum()),
              occluded_plain=int(occ_p.sum()),
              flag_agree=float((occ_k == occ_p).float().mean()),
              flags_differing=int((occ_k != occ_p).sum()),
              queue_max=int(q4n.max()), queue_mean=float(q4n.float().mean()),
              queue_overflow=int(ov4),
              ctas=R // dense.CTA_RAYS,
              pairs_needed=flop // (cs.cluster_size * FLOP_PER_TRIANGLE),
              **walk_counts(dense.dense_occluded, a4, q4n, tile, **kb),
              ms=cuda_ms(lambda: dense.dense_occluded(*a4, **kb), 20),
              plain_ms=cuda_ms(lambda: dense.dense_occluded_plain(*a4, **kb),
                               3))
    s4.update(roofline(flop, moved, s4["ms"]))
    emit(dict(phase="kernel", name="K4 dense_occluded", rays=R, tiles=T,
              **s4))
    if s4["flag_agree"] < 0.9995:
        raise AssertionError(f"K4 disagrees with its plain version: {s4}")
    kernels.append(dict(name="dense_occluded", route="cuda",
                        source="rayaccel_tpu_torch/csrc/dense_occl.cu",
                        replaces="rayaccel_tpu/ops/trace_pallas.py:265",
                        max_abs_err=float(s4["flags_differing"] > 0),
                        **kernel_row(s4)))

    occ_b = dense.dense_occluded(*a4, **dense_default)
    occ_bp = dense.dense_occluded_plain(*a4, **plain_default)
    torch.cuda.synchronize()
    flop, moved = kernel_work(dense, "dense_occluded", a4, occ_b,
                              cs.n_clusters, "default")
    s4b = dict(shadow_rays=s4["shadow_rays"], occluded=int(occ_b.sum()),
               occluded_plain=int(occ_bp.sum()),
               flag_agree=float((occ_b == occ_bp).float().mean()),
               flags_differing=int((occ_b != occ_bp).sum()),
               ctas=R // dense.CTA_RAYS,
               staged_bytes=cluster_bytes(cs.G3b, q4c[queued(q4c, q4n)]),
               pairs_needed=flop // (cs.cluster_size * FLOP_PER_TRIANGLE),
               **walk_counts(dense.dense_occluded, a4, q4n, tile,
                             **dense_default),
               vs_fp32=dict(flag_agree=float((occ_b == occ_k).float()
                                             .mean())),
               ms=cuda_ms(lambda: dense.dense_occluded(*a4, **dense_default),
                          20),
               plain_ms=cuda_ms(lambda: dense.dense_occluded_plain(
                   *a4, **plain_default), 3))
    s4b.update(roofline(flop, moved, s4b["ms"], PEAK_BF16_TENSOR_FLOPS))
    emit(dict(phase="kernel", name="K4 dense_occluded bf16", rays=R, tiles=T,
              **s4b))
    if s4b["flag_agree"] < 0.9995:
        raise AssertionError(f"K4 bf16 disagrees with its plain version: "
                             f"{s4b}")
    bf16_rows.append(dict(name="dense_occluded_bf16", route="cuda",
                          source="rayaccel_tpu_torch/csrc/dense_occl.cu",
                          replaces="rayaccel_tpu/ops/trace_pallas.py:265",
                          max_abs_err=float(s4b["flags_differing"] > 0),
                          **kernel_row(s4b)))

    del surf, F4, a4, q4c, q4e, q4n, occ_k, occ_p, occ_b, occ_bp

    # K2 past one CTA's boxes, at the shapes the main path gives it there:
    # the bounce pool of a frame of SPD tetra at size factor 10 (32,768
    # boxes, rtbench/scenes/spd_tetra.py) under its benchmark
    # configuration, the first pass at k = 4 and the restart pass at k = 8
    # on its spill words, each with the count and without it (as the
    # sparse engine launches it), word for word against the plain version.
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "rtbench/configs/spd_tetra_pt.json")) as f:
        cfg_t = json.load(f)
    sd_t = SceneData(**spd_tetra.generate(
        0, max_depth=2, **cfg_t["scene"]["args"]))
    cs_t = compile_clusters(sd_t, cluster_size=cfg_t["cluster_size"],
                            device=dev)
    ctx_t = racc.create_context(racc.Configuration(**cfg_t["configuration"]),
                                device=dev)
    cam_t = racc.Camera.look_at(sd_t.cam_origin, sd_t.cam_dir, sd_t.cam_up,
                                sd_t.cam_fov, sd_t.viewport_width,
                                sd_t.viewport_height)
    r_t = racc.PathTracingRenderer(ctx_t, cam_t, sd_t, tpu_scene=cs_t)
    opts_t = ctx_t.configuration.engine_opts()
    state_t, _ = pathtracer._stage1(cs_t, cam_t.as_arrays(dev), r_t._wave_x,
                                    r_t._wave_y, r_t._wave_alive, key, 2,
                                    "pallas", r_t.tile, opts_t)
    pool_t = state_t["rays"]
    n_box = cs_t.bb.shape[0]
    F8, first, live, id_bits = sparse._select_args(
        cs_t, pool_t.o, safe_inv_dir(pool_t.d), pool_t.tmin,
        torch.where(state_t["alive"], pool_t.tmax,
                    torch.full_like(pool_t.tmax, -1)))
    N = F8.shape[0]
    ub = cs_t.bb_chunks
    pv = first
    k2_args = []
    for k in (opts_t.k_pairs, opts_t.k_restart):
        a = (F8, pv, live, cs_t.bb, k, id_bits)
        sel_p = sparse.select_nearest_plain(*a, chunk=8192)
        s2 = dict(k=k, lanes=N, live_lanes=int(state_t["alive"].sum()),
                  boxes=n_box, chunks=int(ub.shape[0]),
                  split=sparse.select_split(N),
                  prev_words=int((pv > -0x80000000).sum()),
                  chunks_needed=sparse.select_chunks_needed(F8, pv, live, ub,
                                                            id_bits),
                  plain_ms=cuda_ms(lambda: sparse.select_nearest_plain(
                      *a, chunk=8192), 1))
        for count in (True, False):
            kw = dict(chunk_boxes=ub, count=count)
            got = sparse.select_nearest(*a, **kw)
            want = sel_p if count else sel_p[:k + 1]
            tag = "" if count else "_no_count"
            tested = counted(sparse.select_nearest, a, "tested", 1, **kw)[0]
            ms = cuda_ms(lambda: sparse.select_nearest(*a, **kw), 10)
            # The slab tests of the chunks the lanes tested (the kernel's
            # counter), 2,048 boxes a chunk; the rays, the boxes and the
            # output read or written once.
            bound = roofline(tested * SELECT_CHUNK * FLOP_PER_SLAB,
                             nbytes(F8, pv, live, cs_t.bb, ub, got), ms)
            s2.update({"words_differing" + tag: int((got != want).sum()),
                       "chunks_tested" + tag: tested, "ms" + tag: ms,
                       "bound_ms" + tag: bound["bound_ms"],
                       "bound_by" + tag: bound["bound_by"],
                       "share_of_bound" + tag: bound["share_of_bound"]})
        s2["bound_ms_every_box"] = roofline(*kernel_work(
            dense, "select_nearest", a, sel_p, n_box), s2["ms"])["bound_ms"]
        emit(dict(phase="kernel", name="K2 select_nearest past one CTA",
                  **s2))
        if (s2["words_differing"] or s2["words_differing_no_count"]
                or s2["chunks_tested"] != s2["chunks_needed"]
                or not 0 < s2["chunks_tested_no_count"]
                <= s2["chunks_tested"]):
            raise AssertionError(f"K2 past one CTA (k={k}): {s2}")
        k2_args.append(a)
        if pv is first:
            next(row for row in kernels if row["name"] == "select_nearest")[
                "past_one_cta"] = {key_: s2[key_] for key_ in (
                    "boxes", "lanes", "ms_no_count", "bound_ms_no_count",
                    "share_of_bound_no_count", "plain_ms")}
        pv = sel_p[k].contiguous()
    # The profiler's names of those launches, which KERNEL_SYMBOLS must
    # match: each launch three times under one profile (the profiler may
    # lose the last records of a short profile).
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in k2_args:
            for _ in range(3):
                sparse.select_nearest(*a, chunk_boxes=ub, count=False)
        torch.cuda.synchronize()
    named = {e.key: e.device_time_total / 1e3 / e.count
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and re.search(KERNEL_SYMBOLS["select_nearest"], e.key)}
    emit(dict(phase="profile", name="K2 select_nearest past one CTA",
              kernel_ms=named))
    if not any("select_chunks_kernel" in key_ for key_ in named):
        raise AssertionError(f"the profile names no select_chunks_kernel "
                             f"launch: {named}")
    del state_t, pool_t, F8, first, live, sel_p, got, k2_args

    # K1 on tetra's primaries, the middle 65,536-ray wave of the same frame:
    # most pass through the pyramid's holes, and the gate keeps each CTA to
    # the queued clusters its own rays enter. Its counts beside the tile
    # walk's, its ms and its bound over the pairs the rays' own boxes need.
    wt = r_t.n_waves // 2
    rays_t = pathtracer._primary_rays(cam_t.as_arrays(dev), r_t._wave_x[wt],
                                      r_t._wave_y[wt], rng.fold_in(key, wt))
    Ft, *qt = dense._dense_inputs(cs_t, rays_t, r_t._wave_alive[wt],
                                  r_t.tile, opts_t.k_step, opts_t.tile_cap)
    args_t = (Ft, cs_t.G3, qt[0], qt[1], qt[2], r_t.tile, opts_t.k_step)
    kb_t = dict(boxes=dense.cluster_boxes(cs_t))
    out_kt = dense.dense_closest_hit(*args_t, **kb_t)
    out_pt = dense.dense_closest_hit_plain(*args_t, **kb_t)
    torch.cuda.synchronize()
    hit_kt, t_kt = winner_t(out_kt[1], cs_t, rays_t)
    hit_pt, t_pt = winner_t(out_pt[1], cs_t, rays_t)
    s1t = hit_stats(hit_kt, hit_pt, out_kt[1], out_pt[1], t_kt, t_pt)
    Rt = Ft.shape[0]
    pairs_t = k1_pairs_entered(dense, *args_t[:5], out_pt[0], r_t.tile,
                               **kb_t)
    s1t.update(rays=Rt, tiles=Rt // r_t.tile, ctas=Rt // dense.CTA_RAYS,
               active=int(r_t._wave_alive[wt].sum()),
               queue_max=int(qt[2].max()),
               queue_mean=float(qt[2].float().mean()),
               queue_overflow=int(qt[3]),
               words_differing=int((out_kt != out_pt).sum()),
               pairs_entered=pairs_t,
               **walk_counts(dense.dense_closest_hit, args_t, qt[2],
                             r_t.tile, **kb_t),
               ms=cuda_ms(lambda: dense.dense_closest_hit(*args_t, **kb_t),
                          20))
    qc_t = qt[0][queued(qt[0], qt[2])]
    s1t.update(roofline(pairs_t * cs_t.cluster_size * FLOP_PER_TRIANGLE,
                        nbytes(*args_t[:1], *qt[:3], out_kt)
                        + cluster_bytes(cs_t.G3, qc_t), s1t["ms"]))
    emit(dict(phase="kernel", name="K1 dense_closest_hit tetra", **s1t))
    require_oracle_bar("K1 tetra", s1t)
    del sd_t, cs_t, r_t, ctx_t, rays_t, Ft, qt, args_t, out_kt, out_pt, qc_t
    torch.cuda.empty_cache()

    # The threefry draws: each draw shape at a wave's width and the bounce
    # pool's against its plain int64 path, bit for bit, the plain path's
    # ms beside (some 180 elementwise launches a cipher call), and the
    # bound. Positional draws take the first BSDF draw's (R, 3); lane ids
    # and pixels run over the frame in order. The kernel table's row
    # carries the lane-keyed draw at the pool's width (the frame's widest
    # draw) and each shape at each width under ``by_shape``.
    draws_row = dict(name="threefry_draws", route="cuda",
                     source="rayaccel_tpu_torch/csrc/threefry.cu",
                     replaces="none: jax.random's threefry, fused by XLA",
                     max_abs_err=0.0, by_shape={})
    tkey = rng.fold_in(rng.PRNGKey(0x5EED), 3)
    for width in (65536, 983040):
        ids = torch.arange(width, dtype=torch.int32, device=dev)
        pix = (ids // 1280) << 16 | ids % 1280
        cases = (
            (rng._POSITIONAL, None, 3 * width,
             lambda: rng.uniform(tkey, (width, 3), dev),
             lambda: rng.uniform_plain(tkey, (width, 3), dev)),
            (rng._LANE, ids, width, lambda: rng.lane_uniform(tkey, ids),
             lambda: rng.lane_uniform_plain(tkey, ids)),
            (rng._PAIR, pix, width,
             lambda: rng.fold_in_uniform_pair(tkey, pix),
             lambda: rng.fold_in_uniform_pair_plain(tkey, pix)))
        for shape, shape_ids, rows, kernel_fn, plain_fn in cases:
            name = THREEFRY_SHAPES[shape]
            before = rng.threefry_draws.launches
            got, want = kernel_fn(), plain_fn()
            torch.cuda.synchronize()
            st = dict(rows=rows, width=width, floats=got.numel(),
                      launches=rng.threefry_draws.launches - before,
                      words_differing=int((got.view(torch.int32)
                                           != want.view(torch.int32)).sum()),
                      ms=cuda_ms(kernel_fn, 50), plain_ms=cuda_ms(plain_fn, 5))
            ops, moved = kernel_work(dense, "threefry_draws",
                                     (shape, tkey, shape_ids, rows), got, 0)
            st.update(roofline(ops, moved, st["ms"], PEAK_INT32_OPS))
            st["int_ops"] = st.pop("flop")
            emit(dict(phase="kernel", name=f"threefry {name}", **st))
            if st["words_differing"] or st["launches"] != 1:
                raise AssertionError(f"threefry {name} at {width}: {st}")
            draws_row["by_shape"][f"{name} {width}"] = kernel_row(st)
            if shape == rng._LANE and width == 983040:
                draws_row.update(kernel_row(st))
        del ids, pix, got, want
    kernels.append(draws_row)

    if sys.argv[1:] == ["--kernels"]:
        emit(dict(kernels_ok=True, kernels=kernels + bf16_rows + probe_rows))
        return 0

    wrappers = (dense.dense_closest_hit, dense.dense_occluded,
                sparse.select_nearest, sparse.pair_hit, rng.threefry_draws)
    slices = {}
    # The ``racc.shade.rng`` spans rng.py opens, counted as it opens them:
    # a slice holds the threefry launches to one a span.
    rng_spans = [0]
    open_span = rng.span

    def counted_span(name):
        rng_spans[0] += name == "racc.shade.rng"
        return open_span(name)

    rng.span = counted_span

    def reset_counts():
        for fn in wrappers:
            fn.launches = 0
            if fn.__name__ in BF16_KERNELS:
                fn.launches_bf16 = 0
        sparse.pair_hit.guard_launches = 0
        rng_spans[0] = 0

    def read_counts():
        """Launches of each kernel-table row: a wrapper's fp32 launches
        under its name, its bf16 variant's under ``name_bf16``."""
        c = {}
        for fn in wrappers:
            bf16 = fn.launches_bf16 if fn.__name__ in BF16_KERNELS else 0
            c[fn.__name__] = fn.launches - bf16
            if fn.__name__ in BF16_KERNELS:
                c[row_name(fn.__name__, "default")] = bf16
        c["pair_hit_guard_tmax"] = sparse.pair_hit.guard_launches
        return c

    def require_launches(name, launches, needed):
        missing = [k for k in needed if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{name}: {missing} never launched: "
                                 f"{launches}")

    def drive(name, renderer, keys, needed, deep=True, **extra):
        """One warm-up frame, then ``keys`` timed, with every launch count
        set to 0 just before them and read just after. Emits the slice's
        line; raises unless each kernel in ``needed`` and the threefry
        draws launched, the draws once a ``racc.shade.rng`` span, ``dropped``
        is 0 and the image is finite and not black. With ``deep``, the
        slice's profiled frame and launch frame follow and its counts enter
        the kernel table."""
        needed = [*needed, "threefry_draws"]
        torch.cuda.reset_peak_memory_stats()
        renderer.render_frame(rng.PRNGKey(100))          # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rays_traced = 0
        for k in keys:
            rays_traced += int(renderer.render_frame(k).rays_traced)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        img = renderer.image()
        line = dict(
            phase="slice", name=name,
            viewport=[renderer.width, renderer.height],
            max_depth=renderer.max_depth, spp=renderer.spp, frames=len(keys),
            frame_ms=seconds / len(keys) * 1e3,
            mrays_per_s=rays_traced / seconds / 1e6, rays=rays_traced,
            dropped=renderer.dropped, launches=launches,
            rng_spans=rng_spans[0],
            image_finite=bool(np.isfinite(img).all()),
            image_mean=float(img.mean()), image_max=float(img.max()),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            **{k: f() for k, f in extra.items()})
        emit(line)
        if renderer.dropped != 0:
            raise AssertionError(f"{name} dropped {renderer.dropped} rays")
        require_launches(name, launches, needed)
        if launches["threefry_draws"] != line["rng_spans"]:
            raise AssertionError(f"{name}: {launches['threefry_draws']} "
                                 f"threefry launches in {line['rng_spans']} "
                                 f"racc.shade.rng spans")
        if not (line["image_finite"] and line["image_max"] > 0):
            raise AssertionError(f"{name} image is not finite or is black")
        if not deep:
            return
        kernel_ms = profile_frame(name, renderer)
        unseen = [k for k in needed if not kernel_ms[k] > 0]
        if unseen:
            raise AssertionError(f"{name}: the profile shows no device time "
                                 f"for {unseen}: {kernel_ms}")
        slices[name] = (launches, len(keys), kernel_ms,
                        launch_frame(name, renderer))

    def profile_frame(name, renderer):
        """One more frame under torch.profiler: the device ms of each
        kernel-table row, of K3's unit pass and of all kernels. Emits the
        line and returns the rows' ms."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            renderer.render_frame(rng.PRNGKey(200))
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernel_ms = {k: sum(e.device_time_total for e in device
                            if re.search(symbol, e.key)) / 1e3
                     for k, symbol in KERNEL_SYMBOLS.items()}
        all_ms = sum(e.device_time_total for e in device) / 1e3
        units_ms = sum(e.device_time_total for e in device
                       if UNIT_PASS_SYMBOL in e.key) / 1e3
        emit(dict(phase="profile", name=name, kernel_ms=kernel_ms,
                  pair_hit_units_ms=units_ms, all_kernels_ms=all_ms))
        return kernel_ms

    def launch_frame(name, renderer):
        """One more frame in which each kernel launch keeps a copy of its
        inputs and its output; then each launch is timed again alone
        (``cuda_ms``, as the kernel phases time theirs) and its bound taken
        from its own inputs, at the width the frame gave it. Emits, per
        kernel, the launches, widths, ms, bound ms, share and gap summed
        over the frame, and returns them."""
        calls = record_launches(
            dense, sparse, lambda: renderer.render_frame(rng.PRNGKey(300)))
        per = {k: dict(launches=0, widths=[], ms=0.0, bound_ms=0.0)
               for k in KERNEL_SYMBOLS}
        for fn, a, kw, out in calls:
            precision = kw.get("precision", "highest")
            flop, moved = kernel_work(dense, fn.__name__, a, out,
                                      cs.n_clusters, precision)
            draws = fn.__name__ == "threefry_draws"
            row = per[row_name(fn.__name__, precision)]
            row["launches"] += 1
            row["widths"].append(int(a[3] if draws else a[0].shape[0]))
            row["ms"] += cuda_ms(lambda: fn(*a, **kw), 5)
            row["bound_ms"] += roofline(
                flop, moved, 1.0,
                PEAK_INT32_OPS if draws else peak_flops(precision))["bound_ms"]
        for row in per.values():
            row["share_of_bound"] = (row["bound_ms"] / row["ms"]
                                     if row["ms"] else None)
            row["gap_ms"] = row["ms"] - row["bound_ms"]
        emit(dict(phase="launches", name=name, kernels=per))
        del calls
        return per

    def card_vs_cpu(name, make, keys, **fields):
        """Render ``keys`` with ``make(device)``'s renderer on the card and
        on the host CPU, emit the two-class gate with both ``dropped``
        counts, times and the card run's launch counts, and raise unless
        it passes. Returns the card's launch counts."""
        t0 = time.perf_counter()
        images = {}
        for side, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
            r = make(device)
            reset_counts()
            t1 = time.perf_counter()
            for k in keys:
                r.render_frame(k)
            if side == "cuda":
                torch.cuda.synchronize()
                launches = read_counts()
            images[side] = (r.image().reshape(-1, 3), r.dropped,
                            time.perf_counter() - t1)
            del r
        gate = two_class_gate(images["cuda"][0], images["cpu"][0])
        gate.update(phase=name, **fields, dropped_cuda=images["cuda"][1],
                    dropped_cpu=images["cpu"][1],
                    cuda_seconds=images["cuda"][2],
                    cpu_seconds=images["cpu"][2],
                    seconds=time.perf_counter() - t0)
        emit(dict(gate, launches=launches))
        if not (gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005
                and gate["dropped_cuda"] == gate["dropped_cpu"] == 0):
            raise AssertionError(f"{name} failed: {gate}")
        return launches

    def scene_at(width, height, max_depth):
        return type(sd)(**{**sd.__dict__, "viewport_width": width,
                           "viewport_height": height,
                           "max_depth": max_depth})

    def renderer_on(cls, scene, config=None, **kw):
        """A factory of ``cls`` renderers of ``scene`` on a device, with
        ``config`` (default: the default configuration) and the headline
        cluster scene."""
        def make(device):
            c = racc.create_context(config or racc.default_configuration(),
                                    device=device)
            cam_s = racc.Camera.look_at(
                scene.cam_origin, scene.cam_dir, scene.cam_up, scene.cam_fov,
                scene.viewport_width, scene.viewport_height)
            return cls(c, cam_s, scene, tpu_scene=(
                cs if device == dev else
                cluster_scene_from_numpy(**arrays, device=device)), **kw)
        return make

    # ---- 4. the slice ----
    drive("pt", renderer, [rng.PRNGKey(101 + i) for i in range(3)],
          ["dense_closest_hit", "select_nearest", "pair_hit"])
    del renderer

    # ---- 5. frame gate: card against host CPU ----
    card_vs_cpu("gate",
                renderer_on(racc.PathTracingRenderer, scene_at(320, 180, 2)),
                [rng.fold_in(rng.PRNGKey(7), i) for i in range(2)],
                viewport=[320, 180], spp=2, max_depth=2)

    # ---- 6. Whitted primary + shadow rays (BASELINE config 1) ----
    full = (sd.viewport_width, sd.viewport_height)
    drive("whitted_shadow",
          renderer_on(racc.WhittedRenderer, scene_at(*full, 1),
                      shadows=True, primary_only=True)(dev),
          [rng.PRNGKey(101 + i) for i in range(3)],
          ["dense_closest_hit", "dense_occluded"])

    # ---- 7. Whitted depth-8 ray trees on the frame pool (config 6) ----
    r = renderer_on(racc.WhittedRenderer, scene_at(*full, 8))(dev)
    drive("whitted_depth8", r, [rng.PRNGKey(101 + i) for i in range(2)],
          ["dense_closest_hit", "select_nearest", "pair_hit"],
          bounce_iterations=lambda: r.last_info["iterations"],
          stage_shrinks=lambda: r.last_info["shrinks"],
          deep_hauls=lambda: r.last_info["deep_hauls"])
    del r

    # ---- 8. Whitted gate: depth 8 with shadows, card against host CPU ----
    gw, gh = WHITTED_GATE_VIEWPORT
    launches = card_vs_cpu(
        "whitted_gate",
        renderer_on(racc.WhittedRenderer, scene_at(gw, gh, 8), shadows=True),
        [rng.PRNGKey(9)], viewport=[gw, gh], spp=1, max_depth=8,
        shadows=True)
    require_launches("whitted_gate", launches,
                     ["dense_closest_hit", "dense_occluded", "select_nearest",
                      "pair_hit", "pair_hit_guard_tmax", "threefry_draws"])

    def wall_ms(fn):
        """Milliseconds of one ``fn()`` on the host's clock, the device
        drained before and after. Returns (ms, result)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    # ---- 9. the per-wave path tracer (regroup=False) ----
    per_wave = racc.Configuration(regroup=False)
    drive("pt_wave",
          renderer_on(racc.PathTracingRenderer, scene_at(*full, 2),
                      per_wave)(dev),
          [rng.PRNGKey(101 + i) for i in range(2)],
          ["dense_closest_hit", "select_nearest", "pair_hit"])

    # ---- 10. the stratified sampler on the pooled path (config 4) ----
    r = renderer_on(racc.PathTracingRenderer, scene_at(*full, 2),
                    racc.Configuration(sampler="stratified"))(dev)
    drive("pt_stratified", r, [rng.PRNGKey(101 + i) for i in range(2)],
          ["dense_closest_hit", "select_nearest", "pair_hit"], deep=False,
          # One wave's rotation draws and jitter alone (host clock).
          jitter_ms_a_wave=lambda: wall_ms(
              lambda: pathtracer._stratified_jitter(
                  r._wave_x[0], r._wave_y[0], 1, r._sampler_key))[0])
    del r

    # ---- 11. one wave of Whitted trees, the per-wave path ----
    probe = renderer_on(racc.WhittedRenderer, scene_at(*full, 4),
                        shadows=True)(dev)
    w = probe.n_waves // 2

    def tree_wave():
        return whitted.whitted_trace_wave(
            cs, probe.environment, cam_arrays, probe._wave_x[w],
            probe._wave_y[w], probe._wave_alive[w], rng.fold_in(key, w), 4,
            stack_size=probe.stack_size, backend="pallas", tile=tile,
            shadows=True, bounce_backend="sparse", opts=opts)

    tree_wave()                                             # warm-up
    reset_counts()
    ms, (rad, traced, dropped) = wall_ms(tree_wave)
    launches = read_counts()
    line = dict(phase="whitted_wave", lanes=int(rad.shape[0]), max_depth=4,
                stack_columns=probe.stack_size * 10, ms=ms, rays=int(traced),
                dropped=int(dropped), launches=launches,
                radiance_finite=bool(torch.isfinite(rad).all()),
                radiance_max=float(rad.max()))
    emit(line)
    require_launches("whitted_wave", launches,
                     ["dense_closest_hit", "dense_occluded", "select_nearest",
                      "pair_hit", "pair_hit_guard_tmax", "threefry_draws"])
    if not (line["dropped"] == 0 and line["radiance_finite"]
            and line["radiance_max"] > 0):
        raise AssertionError(f"whitted_wave failed: {line}")
    del probe, rad

    # ---- 12. the plain engines against the dense engine ----
    t0 = time.perf_counter()
    ts = compile_scene(sd, device=dev)
    compile_s = time.perf_counter() - t0
    small = renderer_on(racc.PathTracingRenderer, scene_at(320, 180, 2))(dev)
    if small.n_waves != 1:
        raise AssertionError("the 320x180 viewport is not one wave")
    cam_small = small.camera.as_arrays(dev)
    e_rays = pathtracer._primary_rays(cam_small, small._wave_x[0],
                                      small._wave_y[0], rng.fold_in(key, 0))
    e_alive = small._wave_alive[0]

    def dense_hits():
        return dense.trace_dense(cs, e_rays, active=e_alive, tile=tile,
                                 k_step=opts.k_step, tile_cap=opts.tile_cap)

    def sparse_hits():
        return sparse.trace_sparse(
            cs, e_rays, active=e_alive, k_pairs=opts.k_pairs,
            pair_budget=opts.pair_budget, sp_tile=opts.sp_tile,
            max_passes=opts.max_passes, k_first=opts.k_first,
            k_restart=opts.k_restart)

    dense_hits()                                            # warm-up
    dense_ms, (ref_res, ref_ov) = wall_ms(dense_hits)
    ref = ref_res.hits
    engines = {
        "sparse": lambda: sparse_hits()[0].hits,
        "mxu": lambda: trace_mxu(cs, e_rays, active=e_alive, tile=tile).hits,
        "xla": lambda: trace_bvh(ts, e_rays, active=e_alive),
        # The oracle takes no mask: it is compared on the live lanes.
        "bruteforce": lambda: trace_bruteforce(ts.tri_verts, e_rays),
    }
    engine_lines = {}
    for name, fn in engines.items():
        reset_counts()
        ms, got = wall_ms(fn)
        counts = read_counts()
        st = hit_stats((got.tri >= 0)[e_alive], (ref.tri >= 0)[e_alive],
                       got.tri[e_alive], ref.tri[e_alive], got.t[e_alive],
                       ref.t[e_alive])
        st.update(ms=ms, launches=counts)
        engine_lines[name] = st
        require_oracle_bar(f"engine {name}", st)
        del got
    sparse_ov = int(sparse_hits()[1])
    plain_launched = {n: sum(engine_lines[n]["launches"].values())
                      for n in ("mxu", "xla", "bruteforce")}
    if any(plain_launched.values()):
        raise AssertionError(f"a plain engine launched a kernel: "
                             f"{plain_launched}")
    require_launches("sparse primaries", engine_lines["sparse"]["launches"],
                     ["select_nearest", "pair_hit"])

    # The wave's shadow rays, as the Whitted step builds them.
    e_surf = surface_from_attrs(ref_res.attrs, cs.mat_params, e_rays, ref)
    e_srays = whitted.shadow_rays(e_surf)
    e_sactive = e_alive & (ref.tri >= 0)

    def k4_flags():
        return dense.trace_occlusion_dense(
            cs, e_srays, active=e_sactive, tile=tile, k_step=opts.k_step,
            tile_cap=opts.tile_cap)

    k4_flags()                                              # warm-up
    k4_ms, (occ_ref, occ_ov) = wall_ms(k4_flags)
    occl_lines = {}
    for name, fn in (
            ("mxu", lambda: trace_occlusion_mxu(cs, e_srays,
                                                active=e_sactive, tile=tile)),
            ("xla", lambda: trace_occlusion_bvh(ts, e_srays,
                                                active=e_sactive))):
        ms, occ = wall_ms(fn)
        occl_lines[name] = dict(
            ms=ms, occluded=int(occ.sum()),
            flag_agree=float((occ == occ_ref).float().mean()))
        if occl_lines[name]["flag_agree"] < 0.9995:
            raise AssertionError(f"trace_occlusion on {name} disagrees with "
                                 f"K4: {occl_lines[name]}")
    emit(dict(phase="engines", viewport=[320, 180],
              lanes=int(e_alive.numel()), rays=int(e_alive.sum()),
              triangles=sd.triangle_count, nodes=ts.node_count,
              pairs=ts.pair_count, compile_scene_seconds=compile_s,
              dense_ms=dense_ms, dense_overflow=int(ref_ov),
              sparse_overflow=sparse_ov, engines=engine_lines,
              shadow_rays=int(e_sactive.sum()), k4_ms=k4_ms,
              k4_occluded=int(occ_ref.sum()), k4_overflow=int(occ_ov),
              occlusion=occl_lines))
    if int(ref_ov) or sparse_ov or int(occ_ov):
        raise AssertionError("an engine dropped work on the engines wave")
    del small, ts, ref_res, ref, e_surf, e_srays, occ_ref

    # ---- 13. per-wave gate: card against host CPU ----
    launches = card_vs_cpu(
        "wave_gate",
        renderer_on(racc.PathTracingRenderer, scene_at(320, 180, 2),
                    per_wave),
        [rng.fold_in(rng.PRNGKey(7), i) for i in range(2)],
        viewport=[320, 180], spp=2, max_depth=2, regroup=False)
    require_launches("wave_gate", launches,
                     ["dense_closest_hit", "select_nearest", "pair_hit"])

    # ---- 14. scene file round trip ----
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.bin")
        t0 = time.perf_counter()
        save_scene(path, sd)
        loaded = load_scene(path)
        io_line = dict(phase="scene_io", bytes=os.path.getsize(path),
                       seconds=time.perf_counter() - t0)
    fields = ("vertices", "indices", "triangle_materials",
              "triangle_normals", "normals", "texcoords", "materials",
              "env_pixels", "cam_origin", "cam_dir", "cam_up")
    differing = [f for f in fields
                 if getattr(loaded, f).dtype != getattr(sd, f).dtype
                 or not np.array_equal(getattr(loaded, f), getattr(sd, f))]
    scalars = ("max_depth", "viewport_width", "viewport_height", "cam_fov")
    differing += [f for f in scalars if getattr(loaded, f) != getattr(sd, f)]
    emit(dict(io_line, arrays=len(fields), differing=differing))
    if differing:
        raise AssertionError(f"scene_io: {differing} did not round-trip")

    # Launches of the app-shell phases, read around each phase's run.
    app_launches = {}

    def run_cli(argv):
        """The port's CLI in process, every launch count set to 0 just
        before and read just after. Returns (renderer, stats, launches,
        seconds)."""
        args = racc_cli.build_parser().parse_args(argv)
        reset_counts()
        t0 = time.perf_counter()
        renderer, stats = racc_cli.run(args)
        torch.cuda.synchronize()
        return renderer, stats, read_counts(), time.perf_counter() - t0

    def frame_lines(stats):
        return [dict(ms=s * 1e3, mrays_per_s=r / s / 1e6, rays=r)
                for r, s in stats._window]

    # ---- 15. the CLI: the path tracer at depth 8 and 1280x720 ----
    # The launches over the render alone are read when the CLI starts its
    # --profile stage timing.
    render_counts = {}
    original_profile = profiling.profile_stages

    def counted_profile(renderer, *a, **kw):
        render_counts.update(read_counts())
        return original_profile(renderer, *a, **kw)

    profiling.profile_stages = counted_profile
    with tempfile.TemporaryDirectory() as tmp:
        pfm = os.path.join(tmp, "pt.pfm")
        try:
            r, stats, launches, seconds = run_cli(
                ["--synthetic", "battlefield", "--spp", "4", "--profile",
                 "--out", pfm])
        finally:
            profiling.profile_stages = original_profile
        hdr = read_pfm(pfm)
        png = os.path.join(tmp, "pt.png")
        image.write_png(png, image.tonemap(r.image(), 1))
        with open(png, "rb") as f:
            png_head = f.read(24)
        png_bytes = os.path.getsize(png)
    frames = stats.summary()["frames"]
    line = dict(
        phase="cli", viewport=[r.width, r.height], max_depth=r.max_depth,
        renderer=type(r).__name__, backend=r.backend,
        bounce_backend=r.bounce_backend, spp=r.spp,
        frames=frame_lines(stats),
        frame_ms=stats.total_seconds / frames * 1e3,
        mrays_per_s=stats.total_rays / stats.total_seconds / 1e6,
        rays_traced_total=stats.summary()["rays_traced_total"],
        dropped=r.dropped, launches=render_counts,
        launches_per_frame={k: v / frames for k, v in render_counts.items()},
        launches_with_profile=launches, stages=stats.stages,
        seconds=seconds, pfm_shape=list(hdr.shape),
        image_finite=bool(np.isfinite(hdr).all()),
        image_mean=float(hdr.mean()), image_max=float(hdr.max()),
        png_signature=png_head[:8] == b"\x89PNG\r\n\x1a\n",
        png_size=list(np.frombuffer(png_head[16:24], ">u4").tolist()),
        png_bytes=png_bytes)
    emit(line)
    app_launches["cli"] = (render_counts, frames)
    require_launches("cli", render_counts,
                     ["dense_closest_hit", "select_nearest", "pair_hit",
                      "threefry_draws"])
    if not (r.dropped == 0 and r.max_depth == 8 and r.spp == 4
            and line["pfm_shape"] == [720, 1280, 3]
            and line["image_finite"] and line["image_max"] > 0
            and line["png_signature"] and line["png_size"] == [1280, 720]
            and set(stats.stages or ()) == {
                "primary_trace_ms", "bounce_trace_ms", "shade_ms",
                "env_sample_ms"}):
        raise AssertionError(f"cli failed: {line}")
    # One more frame under the profiler: the kernels' device ms.
    cli_kernel_ms = profile_frame("cli", r)
    unseen = [k for k in ("dense_closest_hit", "select_nearest", "pair_hit")
              if not cli_kernel_ms[k] > 0]
    if unseen:
        raise AssertionError(f"cli: the profile shows no device time for "
                             f"{unseen}: {cli_kernel_ms}")
    del r, stats, hdr

    # ---- 16. CLI resume: bitwise against the render with no break ----
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--synthetic", "battlefield", "--max-depth", "2",
                  "--quiet"]
        a, c = os.path.join(tmp, "a.pfm"), os.path.join(tmp, "c.pfm")
        ck = os.path.join(tmp, "ck")
        runs = {}
        for name, extra in (
                ("a", ["--spp", "4", "--seed", "5", "--out", a]),
                ("b", ["--spp", "2", "--seed", "5", "--checkpoint", ck,
                       "--out", os.path.join(tmp, "b.pfm")]),
                ("c", ["--spp", "4", "--seed", "999", "--checkpoint", ck,
                       "--out", c])):
            r, stats, launches, seconds = run_cli(common + extra)
            runs[name] = dict(spp=r.spp, frames=stats.summary()["frames"],
                              dropped=r.dropped, seconds=seconds,
                              launches=launches)
            del r, stats
        ia, ic = read_pfm(a), read_pfm(c)
        line = dict(phase="cli_resume", runs=runs,
                    bitwise_equal=bool(np.array_equal(ia, ic)),
                    values_differing=int((ia != ic).sum()),
                    max_abs_diff=float(np.abs(ia - ic).max()))
    emit(line)
    if not (line["bitwise_equal"] and runs["c"]["frames"] == 2
            and all(x["dropped"] == 0 for x in runs.values())):
        raise AssertionError(f"cli_resume failed: {line}")

    # ---- 17. the CLI's Whitted renderer at depth 8 ----
    with tempfile.TemporaryDirectory() as tmp:
        r, stats, launches, seconds = run_cli(
            ["--synthetic", "battlefield", "--whitted", "--spp", "1",
             "--quiet", "--out", os.path.join(tmp, "w.pfm")])
        hdr = read_pfm(os.path.join(tmp, "w.pfm"))
    line = dict(phase="cli_whitted", viewport=[r.width, r.height],
                max_depth=r.max_depth, frames=frame_lines(stats),
                dropped=r.dropped, launches=launches,
                bounce_iterations=r.last_info.get("iterations"),
                seconds=seconds, image_finite=bool(np.isfinite(hdr).all()),
                image_max=float(hdr.max()))
    emit(line)
    app_launches["cli_whitted"] = (launches, 1)
    require_launches("cli_whitted", launches,
                     ["dense_closest_hit", "select_nearest", "pair_hit",
                      "threefry_draws"])
    if not (r.dropped == 0 and r.max_depth == 8 and line["image_finite"]
            and line["image_max"] > 0):
        raise AssertionError(f"cli_whitted failed: {line}")
    del r, stats, hdr

    # ---- 18. the live viewer ----
    import threading
    import urllib.request
    vr = renderer_on(racc.PathTracingRenderer, scene_at(320, 180, 8))(dev)
    viewer = Viewer(vr, rng.PRNGKey(0), sd.cam_up, port=0)
    cleared = threading.Event()
    clear = vr.clear

    def record_clear():
        clear()
        cleared.set()

    def wait_for(cond, what, seconds=120):
        deadline = time.time() + seconds
        while not cond():
            if time.time() > deadline:
                raise AssertionError(f"viewer: {what} within {seconds} s")
            time.sleep(0.05)

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{path}",
                                    timeout=60) as resp:
            return resp.read()

    reset_counts()
    thread = threading.Thread(target=viewer.run, kwargs={"quiet": True},
                              daemon=True)
    t0 = time.perf_counter()
    thread.start()
    try:
        wait_for(lambda: vr.spp > 0 and viewer.port, "no frame")
        first_ms = (time.perf_counter() - t0) * 1e3
        # The frame published after the first.
        wait_for(lambda: json.loads(get("/stats"))["spp"] > 0,
                 "no frame published")
        frame_png = get("/frame.png")
        served = json.loads(get("/stats"))
        origin = vr.camera.origin.copy()
        spp_before = vr.spp
        vr.clear = record_clear
        get("/input?key=w")
        wait_for(cleared.is_set, "no reset after a move")
        wait_for(lambda: vr.spp >= 2, "no accumulation after the reset")
        moved = bool(not np.allclose(vr.camera.origin, origin))
        # Steady frames, the presenter's PNG encoding included.
        t1, spp1 = time.perf_counter(), vr.spp
        wait_for(lambda: vr.spp >= spp1 + 4, "no steady frames")
        frame_ms = (time.perf_counter() - t1) * 1e3 / (vr.spp - spp1)
    finally:
        viewer.stop()
        thread.join(timeout=120)
    torch.cuda.synchronize()
    launches = read_counts()
    line = dict(phase="viewer", viewport=[vr.width, vr.height],
                max_depth=vr.max_depth, port=viewer.port,
                first_frame_ms=first_ms, frame_ms=frame_ms,
                png_signature=frame_png[:8] == b"\x89PNG\r\n\x1a\n",
                stats=served, spp_before_move=spp_before,
                camera_moved=moved, reset=cleared.is_set(),
                spp_at_stop=vr.spp, dropped=vr.dropped, launches=launches,
                stopped=not thread.is_alive())
    emit(line)
    app_launches["viewer"] = (launches, None)
    require_launches("viewer", launches,
                     ["dense_closest_hit", "select_nearest", "pair_hit",
                      "threefry_draws"])
    if not (line["png_signature"] and served["spp"] >= 1 and moved
            and line["reset"] and line["stopped"] and vr.dropped == 0):
        raise AssertionError(f"viewer failed: {line}")
    del vr, viewer

    # ---- 19. the mesh path at one rank (BASELINE config 5b) ----
    mesh1 = racc.Configuration(mesh_shape=(1,))
    r = renderer_on(racc.PathTracingRenderer, scene_at(*full, 2), mesh1)(dev)
    drive("mesh1", r, [rng.PRNGKey(101 + i) for i in range(3)],
          ["dense_closest_hit", "select_nearest", "pair_hit"],
          group_backend=lambda: dist.get_backend(r.mesh.group),
          world_size=lambda: dist.get_world_size(r.mesh.group),
          shard_lanes=lambda: r.shard_lanes)
    if (dist.get_backend(r.mesh.group), r.mesh.size) != ("nccl", 1):
        raise AssertionError(f"mesh1 ran on {r.mesh}, not one NCCL rank")
    del r

    # ---- 20. mesh gate: one-rank meshes, card against host CPU ----
    for name, cls, depth, kw, needed in (
            ("pt", racc.PathTracingRenderer, 2, {},
             ["dense_closest_hit", "select_nearest", "pair_hit"]),
            ("whitted", racc.WhittedRenderer, 3, dict(shadows=True),
             ["dense_closest_hit", "dense_occluded", "select_nearest",
              "pair_hit"])):
        launches = card_vs_cpu(
            "mesh1_gate",
            renderer_on(cls, scene_at(320, 180, depth), mesh1, **kw),
            [rng.PRNGKey(9)], renderer=name, viewport=[320, 180], spp=1,
            max_depth=depth, shadows=bool(kw))
        require_launches(f"mesh1_gate {name}", launches,
                         [*needed, "threefry_draws"])
    dist.destroy_process_group()

    def require_no_fp32(name, launches):
        """At precision "default" no fp32 form of K1, K3 or K4 runs."""
        fp32 = {k: launches[k] for k in BF16_KERNELS if launches[k]}
        if fp32:
            raise AssertionError(f"{name}: fp32 kernels launched at "
                                 f"precision='default': {launches}")

    # ---- 21. the path tracer at precision "default" ----
    cfg_default = racc.Configuration(precision="default")
    drive("pt_default",
          renderer_on(racc.PathTracingRenderer, scene_at(*full, 2),
                      cfg_default)(dev),
          [rng.PRNGKey(101 + i) for i in range(3)],
          ["dense_closest_hit_bf16", "select_nearest", "pair_hit_bf16"])
    require_no_fp32("pt_default", slices["pt_default"][0])

    # ---- 22. "default" against "highest" on the card, no bar ----
    for name, cls, depth, kw, needed in (
            ("pt", racc.PathTracingRenderer, 2, {},
             ["dense_closest_hit_bf16", "select_nearest", "pair_hit_bf16"]),
            ("whitted", racc.WhittedRenderer, 3, dict(shadows=True),
             ["dense_closest_hit_bf16", "dense_occluded_bf16",
              "select_nearest", "pair_hit_bf16"])):
        t0 = time.perf_counter()
        images = {}
        for precision in ("default", "highest"):
            r = renderer_on(cls, scene_at(*full, depth),
                            racc.Configuration(precision=precision), **kw)(dev)
            reset_counts()
            r.render_frame(rng.PRNGKey(9))
            torch.cuda.synchronize()
            images[precision] = (r.image().reshape(-1, 3), r.dropped,
                                 read_counts())
            del r
        launches = images["default"][2]
        gate = two_class_gate(images["default"][0], images["highest"][0])
        emit(dict(gate, phase="default_gate", renderer=name,
                  viewport=list(full), spp=1, max_depth=depth,
                  shadows=bool(kw), dropped_default=images["default"][1],
                  dropped_highest=images["highest"][1], launches=launches,
                  seconds=time.perf_counter() - t0))
        app_launches[f"default_gate_{name}"] = (launches, 1)
        require_launches(f"default_gate {name}", launches,
                         [*needed, "threefry_draws"])
        require_no_fp32(f"default_gate {name}", launches)
        if images["default"][1] or images["highest"][1]:
            raise AssertionError(f"default_gate {name} dropped rays: "
                                 f"{images['default'][1]}, "
                                 f"{images['highest'][1]}")
        if not np.isfinite(images["default"][0]).all():
            raise AssertionError(f"default_gate {name}: image not finite")
        del images

    # ---- 23. the scanned dense bounce on the pooled Whitted loop ----
    scan = 65536
    runs = {}
    for bounce_scan in (scan, None):
        r = renderer_on(racc.WhittedRenderer, scene_at(*full, 8),
                        racc.Configuration(hybrid_tracing=False,
                                           whitted_bounce_scan=bounce_scan))(
                                               dev)
        if bounce_scan:
            r.render_frame(rng.PRNGKey(100))                 # warm-up
            r.clear()
        before = r.dropped
        live_waves = int(r._wave_alive.any(dim=1).sum())
        reset_counts()
        ms, _ = wall_ms(lambda: r.render_frame(rng.PRNGKey(101)))
        runs[bounce_scan] = dict(
            ms=ms, launches=read_counts(), live_waves=live_waves,
            dropped=r.dropped - before, info=dict(r.last_info),
            rad=r.frame_buffer.clone())
        del r
    a, b = runs[scan], runs[None]
    ulp = (a["rad"].view(torch.int32).long()
           - b["rad"].view(torch.int32).long()).abs()
    line = dict(phase="whitted_scan", viewport=list(full), max_depth=8,
                bounce_scan=scan, frame_ms=a["ms"], no_scan_ms=b["ms"],
                dropped=a["dropped"], dropped_no_scan=b["dropped"],
                launches=a["launches"], launches_no_scan=b["launches"],
                bounce_k1_launches=a["launches"]["dense_closest_hit"]
                - a["live_waves"],
                bounce_iterations=a["info"].get("iterations"),
                stage_shrinks=a["info"].get("shrinks"),
                max_ulp=int(ulp.max()), values_differing=int((ulp > 0).sum()),
                radiance_finite=bool(torch.isfinite(a["rad"]).all()),
                radiance_max=float(a["rad"].max()))
    emit(line)
    app_launches["whitted_scan"] = (a["launches"], 1)
    if line["bounce_k1_launches"] <= 0:
        raise AssertionError(f"whitted_scan: K1 did not launch in the "
                             f"bounce loop: {line}")
    if a["launches"]["select_nearest"] or a["launches"]["pair_hit"]:
        raise AssertionError(f"whitted_scan: the sparse engine ran: {line}")
    if not (line["max_ulp"] <= 2 and line["dropped"] == line["dropped_no_scan"]
            and line["radiance_finite"] and line["radiance_max"] > 0):
        raise AssertionError(f"whitted_scan failed: {line}")
    del runs, a, b

    # ---- 24. Whitted primary + shadow rays at precision "default" ----
    drive("whitted_shadow_default",
          renderer_on(racc.WhittedRenderer, scene_at(*full, 1), cfg_default,
                      shadows=True, primary_only=True)(dev),
          [rng.PRNGKey(101 + i) for i in range(3)],
          ["dense_closest_hit_bf16", "dense_occluded_bf16"])
    require_no_fp32("whitted_shadow_default",
                    slices["whitted_shadow_default"][0])

    # ---- 25. the ray-set oracle: the cluster engines against mxu ----
    t0 = time.perf_counter()
    rows, set_launches = [], {}
    for set_name, set_rays, engines in oracle_lib.ray_sets(
            cs, sd, ORACLE_RAYS):
        reset_counts()
        rows += oracle_lib.compare_set(cs, set_name, set_rays, engines)
        torch.cuda.synchronize()
        set_launches[set_name] = read_counts()
    sky = set_launches["sky"]
    oracle_ok = oracle_lib.oracle_bar(rows)
    emit(dict(phase="oracle", n_rays=ORACLE_RAYS, ok=oracle_ok, rows=rows,
              launches=set_launches,
              sky_k2=("launched" if sky["select_nearest"] else "skipped"),
              sky_k3=("launched" if sky["pair_hit"] else "skipped"),
              seconds=time.perf_counter() - t0))
    if not oracle_ok:
        raise AssertionError(f"oracle: a row fails the bar: {rows}")
    require_launches("oracle primary", set_launches["primary"],
                     ["dense_closest_hit", "dense_occluded", "select_nearest",
                      "pair_hit"])
    require_launches("oracle scattered", set_launches["scattered"],
                     ["select_nearest", "pair_hit"])
    app_launches["oracle"] = (
        {k: sum(c[k] for c in set_launches.values()) for k in sky}, None)

    # ---- 26. the image oracle: the production frame against xla ----
    t0 = time.perf_counter()
    reset_counts()
    img_oracle = oracle_lib.run_image_oracle(cs, sd, n_spp=2,
                                             viewport=(320, 180),
                                             max_depth=2)
    launches = read_counts()
    emit(dict(phase="image_oracle", **img_oracle, launches=launches,
              seconds=time.perf_counter() - t0))
    if not (img_oracle["rmse_trimmed"] < 1e-3
            and img_oracle["frac_flip"] < 0.005
            and img_oracle["dropped"] == 0):
        raise AssertionError(f"image_oracle failed: {img_oracle}")
    require_launches("image_oracle", launches,
                     ["dense_closest_hit", "select_nearest", "pair_hit"])
    app_launches["image_oracle"] = (launches, None)

    # ---- 27. the port's benchmark, configs 2 and 5 ----
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rayaccel_tpu_torch.bench"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, "BENCH_ONLY": BENCH_ONLY, "BENCH_FRAMES": "2"},
        capture_output=True, text=True, timeout=900)
    bench_lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    emit(dict(phase="bench", rc=proc.returncode,
              seconds=time.perf_counter() - t0, lines=bench_lines,
              stderr=proc.stderr[-2000:] if proc.returncode else ""))
    check_bench(proc.returncode, bench_lines)

    # Launches of each kernel over the timed frames of the deep slices and
    # per frame; its device ms in each slice's profiled frame; and, from
    # each slice's launch frame, its launches timed alone at their own
    # widths, their bound and the gap between the two.
    # The app-shell phases add their launches (and the CLI runs its
    # launches a frame).
    kernels += bf16_rows
    for k in kernels:
        n = k["name"]
        k["launches_by_slice"] = {name: c[n] for name, (c, *_) in
                                  slices.items()}
        k["launches_by_slice"].update(
            {name: c[n] for name, (c, _) in app_launches.items()})
        k["launches"] = sum(k["launches_by_slice"].values())
        k["launches_per_frame"] = {name: c[n] / frames for name, (c, frames,
                                                               *_) in
                                   slices.items()}
        k["launches_per_frame"].update(
            {name: c[n] / frames for name, (c, frames) in app_launches.items()
             if frames})
        k["kernel_ms_per_frame"] = {name: ms[n] for name, (_, _, ms, _) in
                                    slices.items()}
        for key in ("ms", "bound_ms", "gap_ms", "share_of_bound"):
            k[f"frame_{key}"] = {name: per[n][key] for name, (*_, per) in
                                 slices.items()}
    # The probes lie on no renderer path: their launches are their own
    # path's (the probes phase).
    emit(dict(kernels=kernels + probe_rows))
    emit(dict(ok=True, device=dict(platform="gpu", kind=kind,
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
