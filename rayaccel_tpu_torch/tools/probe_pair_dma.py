"""The multi-block pair probe P4 on one CUDA device: counterpart of the
repo-root ``tools/probe_pair_dma.py``.

    python -m rayaccel_tpu_torch.tools.probe_pair_dma               # the card
    python -m rayaccel_tpu_torch.tools.probe_pair_dma --device cpu \\
        --width 64 --height 64 --wave-size 4096                     # plain

The probe asks whether K3, the pair kernel, gains from another staging:
each CTA of :func:`pair_hit_mb` (``csrc/pair_hit_mb.cu``, replacing
``_kernel_mb``) owns ``gb`` consecutive SP-pair blocks, walks their
cluster runs in order and stages each run's cluster block with one TMA
bulk copy into a two-stage ring, where K3 (``csrc/pair_hit.cu``) spreads
64-pair work units over the card and stages clusters with 16-byte
``cp.async`` chunks from every thread. Its words equal K3's on every pair
an item covers.

The entry point rebuilds the probe's frame-width bounce pool: the
battlefield-like scene, clusters of 128, 1280x720 (983,040 lanes), the
first bounce of the path tracer's stage 1 under key 3, K = 4 from K2
(``ops/trace_sparse.py:_select``) and the pair arrays of
``_lattice_pairs`` and ``_pair_inputs``. It prints the probe's two lines:

- ``mb_exactness``: ``n_diff``, the covered pairs whose word differs from
  K3's (at each ``gb`` tried), and ``n``, the covered pairs;
- ``pair_kernel_frame_width``: ``base_ms`` (K3), ``mb_ms`` (at ``gb``,
  the first of ``--gb``), ``mb_ms_by_gb``, ``items``, ``blocks``, ``gb``,
  and P4's counters (runs tested, CTAs, bytes staged).

Times are CUDA-event means on the card (None elsewhere). It exits
non-zero when ``n_diff`` is above 0. With no CUDA device and no
``--device`` it raises.
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

SP = 1024            # pairs a block (the port's default sp_tile)
GB = 1               # blocks a CTA (the probe's 4; chosen on the card: PERF.md)
GBS = (1, 2, 4)      # the blocks a CTA that the entry point times
K = 4                # the clusters a ray takes in the first pass
KEY = 3


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


def pair_hit_mb(Fp, G3, items, col_bits: int, guard_tmax: bool, *,
                gb: int = GB, sp: int = SP, starts=None, stats=None,
                err=None, smem: int = 0) -> torch.Tensor:
    """P4: :func:`ops.trace_sparse.pair_hit`'s function (same arguments and
    result: the miss marker where no item covers a pair) with ``gb``
    SP-pair blocks a CTA and each run's cluster staged by one bulk copy.

    ``items`` must be sorted by start (as ``_pair_inputs`` makes them).
    ``starts`` (optional) is :func:`block_runs`' first output, made here
    when None. ``stats`` (optional, a (3,) int64 CUDA tensor) gains the
    runs tested, the CTAs that tested any and the bytes staged. ``err``
    (optional, a (2,) int32 CUDA tensor of zeros) takes the kernel's error
    word for the caller to check (``_kernels.check_device``); without it
    the wrapper reads one after the launch and raises on a failure (a
    barrier wait that timed out, too little shared memory). ``smem``
    (bytes of dynamic shared memory, 0: the ring for clusters of C) is for
    the card tests. On a CPU tensor it runs :func:`pair_hit_mb_plain`."""
    if Fp.device.type == "cpu":
        return pair_hit_mb_plain(Fp, G3, items, col_bits, guard_tmax, sp=sp)
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
    if G3.data_ptr() % 16 or G3[0].numel() * G3.element_size() % 16:
        raise ValueError("a bulk copy of a cluster block needs a 16-byte-"
                         "aligned G3 whose blocks are a multiple of 16 "
                         "bytes")
    _kernels.require(items, "items", torch.int32, (n_items, 3))
    if gb < 1:
        raise ValueError(f"gb must be at least 1, got {gb}")
    n_blocks = -(-P // sp)
    if starts is None:
        starts = block_runs(items, sp, n_blocks)[0]
    _kernels.require(starts, "starts", torch.int32, (n_blocks + 1,))
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
    _kernels.check(_kernels.library().racc_pair_hit_mb(
        _kernels.ptr(Fp), _kernels.ptr(G3), _kernels.ptr(items),
        _kernels.ptr(starts), _kernels.ptr(out),
        None if stats is None else _kernels.ptr(stats), _kernels.ptr(err),
        P, n_c, C, col_bits, int(guard_tmax), n_blocks, gb, smem,
        _kernels.stream()), "racc_pair_hit_mb")
    pair_hit_mb.launches += 1
    if own:
        _kernels.check_device(err, "racc_pair_hit_mb")
    return out


pair_hit_mb.launches = 0


def pair_hit_mb_plain(Fp, G3, items, col_bits: int, guard_tmax: bool, *,
                      sp: int = SP) -> torch.Tensor:
    """Plain torch version of P4: K3's plain arithmetic
    (``ops/trace_sparse.py:pair_words``) block by block, one run at a time,
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


def run(Fp, G3, items, col_bits: int, *, gbs=GBS, sp: int = SP,
        reps: int = 20):
    """The probe on one pass's pair arrays (K3's closest-hit form, as the
    probe ran it): (``mb_exactness`` line, ``pair_kernel_frame_width``
    line) as dicts. P4 runs at each of ``gbs`` (its line reports the
    first) against K3 on the same inputs; times on a CUDA device only."""
    on_card = Fp.device.type == "cuda"
    P = Fp.shape[0]
    n_blocks = -(-P // sp)
    starts = block_runs(items, sp, n_blocks)[0]
    args = (Fp, G3, items, col_bits, False)
    base = sparse.pair_hit(*args)
    live = sparse.covered_pairs(Fp, items)[0]
    n_diff, counters = {}, None
    for gb in gbs:
        stats = (torch.zeros(3, dtype=torch.int64, device=Fp.device)
                 if on_card else None)
        mb = pair_hit_mb(*args, gb=gb, sp=sp, starts=starts, stats=stats)
        n_diff[gb] = int(((mb != base) & live).sum())
        if (mb[~live] != sparse._MISS_BITS).any():
            raise AssertionError(f"P4 (gb={gb}) wrote a pair no item covers")
        if stats is not None and gb == gbs[0]:
            counters = dict(zip(("runs", "ctas", "bytes_staged"),
                                stats.tolist()))
    exact = dict(stage="mb_exactness", n_diff=n_diff[gbs[0]],
                 n=int(live.sum()), n_diff_by_gb=n_diff)
    base_ms, mb_ms = None, {gb: None for gb in gbs}
    if on_card:
        err = torch.zeros(2, dtype=torch.int32, device=Fp.device)
        # K3 first and last, P4's forms between.
        base_ms = cuda_ms(lambda: sparse.pair_hit(*args), reps)
        for gb in gbs:
            mb_ms[gb] = cuda_ms(lambda: pair_hit_mb(
                *args, gb=gb, sp=sp, starts=starts, err=err), reps)
        base_ms = (base_ms + cuda_ms(lambda: sparse.pair_hit(*args),
                                     reps)) / 2
        _kernels.check_device(err, "racc_pair_hit_mb")
    timing = dict(stage="pair_kernel_frame_width", base_ms=base_ms,
                  mb_ms=mb_ms[gbs[0]], mb_ms_by_gb=mb_ms,
                  items=int(items.shape[0]), blocks=n_blocks, gb=gbs[0],
                  pairs=P, counters=counters)
    return exact, timing


def bounce_pairs(device, width: int = 1280, height: int = 720,
                 wave_size: int = 65536, cluster_size: int = 128):
    """The probe's pool: pass 1 of the first bounce of a path-traced frame
    of the battlefield-like scene at ``width`` x ``height`` (waves of
    ``wave_size`` lanes) under key 3, as pair arrays. Returns (Fp, G3,
    items, col_bits, lanes)."""
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
    tmax = torch.where(state["alive"], pool.tmax,
                       torch.full_like(pool.tmax, -1))
    lat_valid, lat_id, _, _ = sparse._select(cs, pool.o,
                                             safe_inv_dir(pool.d), pool.tmin,
                                             tmax, K)
    cap = min(max(SP, -(-opts.pair_budget * N // SP) * SP),
              -(-K * N // SP) * SP)
    cl, ray, rank, _ = sparse._lattice_pairs(lat_valid, lat_id, cap)
    Fp, items = sparse._pair_inputs(pool.o, pool.d, pool.tmin, tmax, cl, ray,
                                    rank, SP)
    col_bits = max((cs.cluster_size - 1).bit_length(), 1)
    return Fp, cs.G3, items, col_bits, N


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA "
                             "device; 'cpu' runs the plain versions)")
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--wave-size", type=int, default=65536)
    parser.add_argument("--gb", default=",".join(map(str, GBS)),
                        help="blocks a CTA to try, the reported one first")
    parser.add_argument("--reps", type=int, default=20,
                        help="timed launches a kernel (card only)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    Fp, G3, items, col_bits, lanes = bounce_pairs(
        device, args.width, args.height, args.wave_size)
    print(json.dumps(dict(device=str(device), lanes=lanes, pairs=Fp.shape[0],
                          name=(torch.cuda.get_device_name(device)
                                if device.type == "cuda" else None))),
          flush=True)
    exact, timing = run(Fp, G3, items, col_bits,
                        gbs=tuple(int(g) for g in args.gb.split(",")),
                        reps=args.reps)
    print(json.dumps(exact), flush=True)
    print(json.dumps(timing), flush=True)
    return 1 if any(exact["n_diff_by_gb"].values()) else 0


if __name__ == "__main__":
    sys.exit(main())
