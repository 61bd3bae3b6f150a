"""The manual-DMA probes P1-P3 on one CUDA device: counterpart of the
repo-root ``tools/probe_dma.py``.

    python -m rayaccel_tpu_torch.tools.probe_dma                # on the card
    python -m rayaccel_tpu_torch.tools.probe_dma --device cpu   # plain versions

Three escalating steps of an async copy from device memory into scratch
memory, each a kernel of ``csrc/probe_dma.cu`` (a TMA bulk copy that
completes on an mbarrier, ``csrc/tma.cuh``), on the probe's x =
arange(64 * 128) as (64, 128) float32:

- A, :func:`copy_static` (P1, ``kern_a``): rows 8:16;
- B, :func:`copy_dynamic` (P2, ``kern_b``): row block ``idx[0]`` (3: rows
  24:32), the index read on the device;
- C, :func:`copy_worklist` (P3, ``kern_c``): the sum from zeros of the row
  blocks of the work list [1, 5, 2, 7], in that order: the TPU kernel
  waits on each block's copy before the next, the port issues every
  block's copy before it waits on any, one stage of shared memory each
  (:func:`worklist_plan`; a longer list goes through the stages as a
  ring), and sums in registers.

Prints one JSON line for the device, then one a step: whether the output
equals the probe's own expectation bit for bit, the kernel's CUDA-event
microseconds and those of the one PyTorch call that computes the same
function (``library``), timed on the card only; on the card step C's line
adds the stage plan the kernel is launched with (``plan``). Exits non-zero
on a mismatch. With no CUDA device and no ``--device`` it raises.

On a CUDA tensor each wrapper checks its argument (float32, 2-D,
contiguous, a 16-byte-aligned start and a block whose bytes are a
multiple of 16, as a bulk copy needs) and launches its kernel, or raises;
on a CPU tensor it runs its plain version. A kernel that reports a
failure in its error word (a barrier wait that timed out, too little
shared memory, an index out of range) raises too.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.ops import _kernels
from rayaccel_tpu_torch.utils.profiling import cuda_ms

ROWS = 8                  # rows of a block: the probe's (8, 128) scratch
STATIC_START = 8          # step A's rows 8:16
DYNAMIC_INDEX = 3         # step B's block: rows 24:32
WORK_LIST = (1, 5, 2, 7)  # step C's blocks

# P3's stages (csrc/probe_dma.cu:sum_plan): a piece of at most 64 KB of a
# block (16 float4s for each of 256 consumer threads) and its full and
# empty mbarriers.
PIECE_BYTES = 256 * 16 * 16
STAGE_BARRIER_BYTES = 16


def probe_input(device) -> torch.Tensor:
    """The probe's x: arange(64 * 128) as (64, 128) float32."""
    return torch.arange(64 * 128, dtype=torch.float32,
                        device=device).reshape(64, 128)


def _check_block(x, rows: int):
    """Validate x for a bulk copy of ``rows`` rows."""
    _kernels.require(x, "x", torch.float32)
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    if not 1 <= rows <= x.shape[0]:
        raise ValueError(f"rows must be in [1, {x.shape[0]}], got {rows}")
    nbytes = rows * x.shape[1] * x.element_size()
    if nbytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"a bulk copy moves a multiple of 16 bytes from a "
                         f"16-byte-aligned address: {rows} rows of x are "
                         f"{nbytes} bytes at {x.data_ptr():#x}")


def _index(idx, n: int | None = None):
    _kernels.require(idx, "idx", torch.int32)
    if idx.dim() != 1 or idx.numel() < 1 or (n is not None
                                              and idx.numel() != n):
        raise ValueError(f"idx must be a 1-D int32 list of "
                         f"{n or 'at least 1'} block indices, got shape "
                         f"{tuple(idx.shape)}")


def _launch(fn, name: str, out, err, smem: int, *args):
    """Launch C entry point ``name`` (wrapper ``fn``) on ``args`` with its
    output, its error word and ``smem``: a fresh error word, checked at
    once, or the caller's ``err``, which the caller checks
    (``_kernels.check_device``) after a run of launches."""
    own = err is None
    if own:
        err = torch.zeros(2, dtype=torch.int32, device=out.device)
    else:
        _kernels.require(err, "err", torch.int32, (2,))
    _kernels.check(getattr(_kernels.library(), name)(
        *args, _kernels.ptr(out), _kernels.ptr(err), smem,
        _kernels.stream()), name)
    fn.launches += 1
    if own:
        _kernels.check_device(err, name)
    return out


def _in_range(first: int, rows: int, R: int):
    if not 0 <= first <= R - rows:
        raise ValueError(f"row block {first}:{first + rows} is outside the "
                         f"{R} rows of x")


def copy_static(x, start: int = STATIC_START, rows: int = ROWS, *,
                err=None, smem: int = 0) -> torch.Tensor:
    """P1: rows start:start + rows of x (R, W) float32 through scratch
    memory. ``err`` (optional, a (2,) int32 CUDA tensor of zeros) takes
    the kernel's error word for the caller to check; ``smem`` (bytes of
    dynamic shared memory, 0: what the kernel needs) is for the card
    tests."""
    if x.device.type == "cpu":
        return copy_static_plain(x, start, rows)
    _check_block(x, rows)
    _in_range(start, rows, x.shape[0])
    if start * x.shape[1] * x.element_size() % 16:
        raise ValueError(f"row {start} of x does not start on 16 bytes")
    out = torch.empty((rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return _launch(copy_static, "racc_probe_static", out, err, smem,
                   _kernels.ptr(x), x.shape[0], x.shape[1], start, rows)


copy_static.launches = 0


def copy_static_plain(x, start: int = STATIC_START,
                      rows: int = ROWS) -> torch.Tensor:
    _in_range(start, rows, x.shape[0])
    return x[start:start + rows].clone()


def copy_dynamic(x, idx, rows: int = ROWS, *, err=None,
                 smem: int = 0) -> torch.Tensor:
    """P2: row block ``idx[0]`` of x (rows idx[0] * rows on), ``idx`` a
    (1,) int32 tensor read on the device. ``err`` and ``smem`` as for
    :func:`copy_static`."""
    if x.device.type == "cpu":
        return copy_dynamic_plain(x, idx, rows)
    _check_block(x, rows)
    _index(idx, 1)
    out = torch.empty((rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return _launch(copy_dynamic, "racc_probe_dynamic", out, err, smem,
                   _kernels.ptr(x), x.shape[0], x.shape[1],
                   _kernels.ptr(idx), rows)


copy_dynamic.launches = 0


def copy_dynamic_plain(x, idx, rows: int = ROWS) -> torch.Tensor:
    first = int(idx[0]) * rows
    _in_range(first, rows, x.shape[0])
    return x[first:first + rows].clone()


def copy_worklist(x, idx, rows: int = ROWS, *, err=None,
                  smem: int = 0) -> torch.Tensor:
    """P3: the sum from zeros of the row blocks ``idx[0]``, ``idx[1]``, ...
    of x, added in that order, ``idx`` an int32 tensor read on the device.
    The kernel checks every index before it copies any block, then issues
    a copy a stage, as many stages as :func:`worklist_plan` fits in the
    card's opt-in shared memory, before any thread waits. ``err`` as for
    :func:`copy_static`; ``smem`` (bytes of dynamic shared memory, 0: the
    plan's) is used as it is, its stages as many as it holds (the card
    tests force too few and too many)."""
    if x.device.type == "cpu":
        return copy_worklist_plain(x, idx, rows)
    _check_block(x, rows)
    _index(idx)
    if not smem:
        block = rows * x.shape[1] * x.element_size()
        smem = worklist_plan(idx.numel(), block,
                             smem_optin(x.device))["smem_bytes"]
    out = torch.empty((rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return _launch(copy_worklist, "racc_probe_worklist", out, err, smem,
                   _kernels.ptr(x), x.shape[0], x.shape[1],
                   _kernels.ptr(idx), idx.numel(), rows)


copy_worklist.launches = 0


def smem_optin(device) -> int:
    """The dynamic shared memory a CTA may opt in to on a CUDA device."""
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def worklist_plan(n: int, block_bytes: int, room: int) -> dict:
    """P3's plan for a work list of ``n`` blocks of ``block_bytes`` (a
    multiple of 16) in ``room`` bytes of dynamic shared memory: each block
    in ``slices`` pieces of at most 64 KB (``piece_bytes``), and
    ``stages`` stages (a piece's buffer and its two barriers), as many as
    fit, at most the list's pieces; 0 where not one fits (the kernel then
    reports too little shared memory). ``smem_bytes`` is what
    :func:`copy_worklist` launches the kernel with: the stages' bytes (one
    stage's where none fits), from which ``csrc/probe_dma.cu`` makes the
    same stages."""
    piece = min(block_bytes, PIECE_BYTES)
    slices = -(-block_bytes // piece)
    stage = piece + STAGE_BARRIER_BYTES
    stages = min(n * slices, room // stage)
    return dict(stages=stages, slices=slices, piece_bytes=piece,
                smem_bytes=max(stages, 1) * stage)


def copy_worklist_plain(x, idx, rows: int = ROWS) -> torch.Tensor:
    acc = torch.zeros((rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in idx.tolist():
        _in_range(i * rows, rows, x.shape[0])
        acc = acc + x[i * rows:i * rows + rows]
    return acc


def expected(step: str) -> np.ndarray:
    """The probe's own expectation of a step (``tools/probe_dma.py:53``,
    ``:84``, ``:120``), in numpy float32: the sum in the list's order."""
    x = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
    if step == "A":
        return x[STATIC_START:STATIC_START + ROWS]
    if step == "B":
        return x[DYNAMIC_INDEX * ROWS:DYNAMIC_INDEX * ROWS + ROWS]
    acc = np.zeros((ROWS, 128), np.float32)
    for i in WORK_LIST:
        acc = acc + x[i * ROWS:i * ROWS + ROWS]
    return acc


def steps(x, rows: int = ROWS):
    """(step, wrapper, its arguments, the PyTorch call that computes the
    same function, that call's text) of the probe on x."""
    dev = x.device
    idx_b = torch.tensor([DYNAMIC_INDEX], dtype=torch.int32, device=dev)
    idx_c = torch.tensor(WORK_LIST, dtype=torch.int32, device=dev)
    blocks = x.view(-1, rows, x.shape[1])
    return [
        ("A", copy_static, (x,), lambda: x[8:16].clone(), "x[8:16].clone()"),
        ("B", copy_dynamic, (x, idx_b),
         lambda: blocks.index_select(0, idx_b)[0],
         "x.view(8, 8, 128).index_select(0, idx)[0]"),
        ("C", copy_worklist, (x, idx_c),
         lambda: blocks.index_select(0, idx_c).sum(0),
         "x.view(8, 8, 128).index_select(0, idx).sum(0)"),
    ]


def run(device, reps: int = 100) -> list:
    """The probe's three steps on ``device``: one line (a dict) a step.
    Times are taken on a CUDA device only (None elsewhere)."""
    x = probe_input(device)
    on_card = x.device.type == "cuda"
    lines = []
    for step, fn, args, library, text in steps(x):
        got = fn(*args)
        ok = bool(np.array_equal(got.cpu().numpy(), expected(step)))
        line = dict(step=step, kernel=fn.__name__, ok=ok, kernel_us=None,
                    library_us=None, library=text)
        if on_card and step == "C":
            line["plan"] = worklist_plan(len(WORK_LIST), got.numel() * 4,
                                         smem_optin(x.device))
        if on_card:
            err = torch.zeros(2, dtype=torch.int32, device=x.device)
            line["kernel_us"] = cuda_ms(lambda: fn(*args, err=err), reps) * 1e3
            _kernels.check_device(err, fn.__name__)
            line["library_us"] = cuda_ms(library, reps) * 1e3
        lines.append(line)
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA "
                             "device; 'cpu' runs the plain versions)")
    parser.add_argument("--reps", type=int, default=100,
                        help="timed launches a step (card only)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(dict(
        device=str(device), name=(torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else None))),
          flush=True)
    lines = run(device, args.reps)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0 if all(line["ok"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
