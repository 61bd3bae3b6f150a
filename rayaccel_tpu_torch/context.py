"""Context lifecycle: counterpart of ``rayaccel_tpu/context.py`` (``init``,
``deinit``, ``create_context``, ``destroy``, ``info``).

The port's context holds the configuration, one explicit ``torch.device``
(every tensor the renderers create lives there) and, with
``mesh_shape=(D,)``, the :class:`~rayaccel_tpu_torch.parallel.mesh.Mesh`
of the D ranks of a ``torch.distributed`` process group, one process a
rank.

Two differences from the JAX context, both decided:

- ``Context.device_count`` is the number of ranks of the mesh, 1 without
  one: the devices this context renders on. The JAX context counts every
  device it can see, mesh or not.
- ``create_context(device=...)`` takes one device, where JAX's
  ``create_context(devices=[...])`` takes a list: a process of the port
  drives one device, and a mesh's other devices belong to its other
  ranks.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch

from rayaccel_tpu_torch.config import (Configuration, ContextInfo,
                                       default_configuration)
from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.ops.trace_dense import check_tile
from rayaccel_tpu_torch.parallel.mesh import Mesh, make_mesh


def init() -> None:
    """Pin fp32 arithmetic: the TPU kernels run ``Precision.HIGHEST``, so no
    float32 matrix product or convolution may drop to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def deinit() -> None:
    """Counterpart of ``rayaccel_tpu/context.py:deinit``: nothing to tear
    down."""


@dataclasses.dataclass
class Context:
    configuration: Configuration
    device: torch.device
    mesh: Optional[Mesh] = None

    @property
    def device_count(self) -> int:
        """The mesh's number of ranks; 1 without a mesh."""
        return self.mesh.size if self.mesh else 1


def create_context(configuration: Optional[Configuration] = None,
                   device=None) -> Context:
    """Build a context on ``device`` (default: the current CUDA device, or
    with a mesh the rank's own, ``cuda:LOCAL_RANK``). The port never picks
    the CPU by itself: with no CUDA device visible and no ``device`` given
    this raises; pass ``device="cpu"`` to run the plain versions on the
    host.

    With ``mesh_shape=(D,)`` the context holds a mesh of the D ranks of the
    initialised default process group (from ``torchrun``, or a launcher
    that calls ``torch.distributed.init_process_group``), in a new group of
    the device's backend (``parallel/mesh.py:make_mesh``). It raises
    ``ValueError`` when that group does not have D ranks, as JAX's "needs n
    devices" does; for D = 1 with no group it forms a one-rank group.

    On a CUDA device the renderers' queue tile, ``min(trace_block,
    min(wave_size, max_rays_in_flight) // D)`` (a rank's lanes of a wave;
    D = 1 without a mesh), must be a multiple of the dense kernels' CTA
    (``ops/trace_dense.py:check_tile``); this raises ``ValueError``
    otherwise. Calls :func:`init`."""
    init()
    cfg = configuration or default_configuration()
    if (device is None and cfg.mesh_shape is not None
            and torch.cuda.is_available()):
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = resolve_device(device)
    n_shards = math.prod(cfg.mesh_shape or (1,))
    if device.type == "cuda":
        check_tile(min(cfg.trace_block,
                       min(cfg.wave_size, cfg.max_rays_in_flight) // n_shards))
    mesh = make_mesh(device, n_shards) if cfg.mesh_shape else None
    return Context(configuration=cfg, device=device, mesh=mesh)


def destroy(context: Context) -> None:
    """Counterpart of ``rayaccel_tpu/context.py:destroy``: tensors are freed
    with their last reference, there is nothing to join."""


def info(context: Context) -> ContextInfo:
    """Counterpart of ``rayaccel_tpu/context.py:info``, with
    :attr:`Context.device_count`."""
    cfg = context.configuration
    return ContextInfo(device_count=context.device_count,
                       wave_size=cfg.wave_size,
                       max_rays_in_flight=cfg.max_rays_in_flight,
                       backend=cfg.backend)
