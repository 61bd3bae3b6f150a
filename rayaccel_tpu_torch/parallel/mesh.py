"""Tile parallelism over ranks of a ``torch.distributed`` process group.

Counterpart of ``rayaccel_tpu/parallel/mesh.py``. The JAX package runs one
program over a ``"tiles"`` mesh axis under ``shard_map``; the port runs
one process per rank, and one rank plays the part of one device of that
axis:

- every rank keeps the block of lanes that ``P(None, "tiles")`` gives
  JAX's shard ``s``: lanes ``[s*R/D, (s+1)*R/D)`` of every wave;
- ``psum`` is ``all_reduce``, ``all_gather`` stays ``all_gather``, and
  JAX's tiled ``all_to_all`` is ``all_to_all_single`` with equal splits;
- the scene is replicated: every rank traces rank 0's arrays.

A :class:`Mesh` owns its process group, made with ``dist.new_group`` for
its device's backend: NCCL for a CUDA device, gloo for the CPU. That is a
named choice, not a fallback: a group that cannot form raises. Every group
has a timeout, so a rank that fails cannot leave the others waiting
forever.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any

import torch
import torch.distributed as dist

from rayaccel_tpu_torch.utils.spans import span

# How long a collective waits for the other ranks before it raises.
GROUP_TIMEOUT = datetime.timedelta(minutes=10)

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass
class Mesh:
    """A one-axis mesh: this process is rank ``rank`` of ``size`` ranks of
    ``group``, and its tensors live on ``device``."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = "tiles"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``psum``: the sum over ranks, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t``, in rank order."""
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return torch.stack(out)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """JAX's tiled ``all_to_all`` on axis 0: rows ``[j*n, (j+1)*n)`` go
        to rank j, and the rows from rank i land at ``[i*n, (i+1)*n)``."""
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        return out


def make_mesh(device, size: int | None = None) -> Mesh:
    """A ``"tiles"`` mesh of every rank of the default process group, each
    on its own ``device``, in a new group of the device's backend.
    ``size`` is the number of ranks the caller needs: the default group
    must have that many, except that with ``size == 1`` and no default
    group a one-rank group is formed here (JAX needs no setup for
    ``mesh_shape=(1,)``).
    Raises ``ValueError`` when the group's size is not ``size``. The
    group's first collective runs here, so a group that cannot form
    raises here and not in a frame."""
    device = torch.device(device)
    backend = _BACKENDS[device.type]
    if not dist.is_initialized():
        if size not in (None, 1):
            raise ValueError(
                f"a mesh of {size} ranks needs an initialised process group "
                f"of {size} ranks, have none: start the ranks with torchrun "
                "or call torch.distributed.init_process_group")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=GROUP_TIMEOUT)
    world = dist.get_world_size()
    if size is not None and world != size:
        raise ValueError(f"a mesh of {size} ranks needs a process group of "
                         f"{size} ranks, have {world}")
    group = dist.new_group(backend=backend, timeout=GROUP_TIMEOUT)
    mesh = Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), device=device,
                backend=backend)
    mesh.all_reduce(torch.zeros(1, device=device))
    return mesh


def sharded_wave(mesh: Mesh, wave_fn, n_pixels: int):
    """Wrap a single-device wave function for tile-parallel execution.

    ``wave_fn(fb_local, base_pixel, key) -> (fb_local, traced)`` treats
    pixel ids relative to its framebuffer shard. Returns ``run(fb_local,
    base, key) -> (fb_local, traced_total)``: each rank passes its own
    (n_pixels / size, 3) shard, base and key, and ``traced`` is summed over
    the ranks."""
    assert n_pixels % mesh.size == 0

    def run(fb_local, base, key):
        fb_local, traced = wave_fn(fb_local, base, key)
        total = torch.as_tensor(traced, dtype=torch.int64).to(mesh.device)
        return fb_local, mesh.all_reduce(total.reshape(1))[0]

    return run


def reshard_balance_cols(S: torch.Tensor, lane: torch.Tensor,
                         alive: torch.Tensor, mesh: Mesh, D: int,
                         slack: int = 256):
    """Cross-rank pooled-state load balance, shared by both frame pools:
    when the ranks' live counts diverge, stripe each rank's live-first
    (stable) sorted pool round-robin over the mesh and exchange the
    slices, so every rank ends within ~D lanes of the mean live count.

    ``S`` is the caller-packed (N, C) float32 state (with an alive column,
    so liveness rides the exchange); ``lane`` holds the global lane ids
    (rank * N + local), by which the rows are routed home at reassembly
    (:func:`route_rows_home`). The exchange fires only when the worst
    rank's count exceeds the mean by more than 25% plus ``slack`` lanes a
    rank; the counts are gathered, so every rank takes the same decision.
    Returns (S, lane, resharded). The placement is bitwise JAX's."""
    N = lane.shape[0]
    assert N % D == 0, f"per-rank pool {N} not divisible by mesh {D}"
    Ns = N // D
    n_live = alive.sum().to(torch.int64).reshape(1).to(mesh.device)
    with span("racc.render.read.rank_counts"):
        counts = mesh.all_gather(n_live).flatten().tolist()
    total = sum(counts)
    need = max(counts) * D > total + total // 4 + D * slack
    if not need:
        return S, lane, False
    iota = torch.arange(N, dtype=torch.int32, device=lane.device)
    perm = torch.argsort(torch.where(alive, iota, 0x7FFFFFFF), stable=True)
    # Stripe: live-rank k lands at slice (k % D), offset (k // D); position
    # j = s*Ns + t therefore takes sorted rank t*D + s.
    src_rank = (iota % Ns) * D + iota // Ns
    take = perm[src_rank.long()]
    return mesh.all_to_all(S[take]), mesh.all_to_all(lane[take]), True


def route_rows_home(rows: torch.Tensor, mesh: Mesh,
                    resharded: bool) -> torch.Tensor:
    """Inverse of the reshard exchange at reassembly: ``rows`` is (N, C)
    with the global lane id in column 0. After a sort by lane, the rows
    from home rank i are exactly the (N/D)-row slice i (the outbound
    stripe sent N/D of each rank's lanes to every rank), so one tiled
    exchange returns every row to the rank that owns its lane. A no-op
    when the exchange did not fire."""
    if not resharded:
        return rows
    return mesh.all_to_all(rows[torch.argsort(rows[:, 0], stable=True)])


def replicate_scene(mesh: Mesh, tree):
    """Rank 0's arrays of ``tree`` (a NamedTuple of tensors: a compiled
    scene or an environment) on every rank's device. The shapes travel
    first, so another rank's own ``tree`` may differ from rank 0's (two
    builds of one scene need not give the same tree)."""
    src = dist.get_global_rank(mesh.group, 0)
    meta = [[(tuple(a.shape), a.dtype) for a in tree]]
    dist.broadcast_object_list(meta, src=src, group=mesh.group,
                               device=mesh.device)
    out = []
    for a, (shape, dtype) in zip(tree, meta[0]):
        if mesh.rank == 0:
            buf = a.to(mesh.device).contiguous()
        else:
            buf = torch.empty(shape, dtype=dtype, device=mesh.device)
        dist.broadcast(buf, src=src, group=mesh.group)
        out.append(buf)
    return type(tree)(*out)
