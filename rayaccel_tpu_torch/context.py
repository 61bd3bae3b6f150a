"""Context lifecycle: counterpart of ``rayaccel_tpu/context.py`` (``init``,
``deinit``, ``create_context``, ``destroy``, ``info``).

The port's context holds the configuration and one explicit
``torch.device``; every tensor the renderers create lives there. There is
no mesh: the multi-device tier is ROADMAP queue 1 item 15.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rayaccel_tpu_torch.config import (Configuration, ContextInfo,
                                       default_configuration)
from rayaccel_tpu_torch.ops.trace_dense import check_tile


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


def create_context(configuration: Optional[Configuration] = None,
                   device=None) -> Context:
    """Build a context on ``device`` (default: the current CUDA device).
    The port never picks the CPU by itself: with no CUDA device visible and
    no ``device`` given this raises; pass ``device="cpu"`` to run the plain
    versions on the host. On a CUDA device the renderers' queue tile,
    ``min(trace_block, wave_size, max_rays_in_flight)``, must be a multiple
    of the dense kernels' CTA (``ops/trace_dense.py:check_tile``); this
    raises ``ValueError`` otherwise. Calls :func:`init`."""
    init()
    cfg = configuration or default_configuration()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: pass "
                               "device=\"cpu\" to run on the host")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        check_tile(min(cfg.trace_block, cfg.wave_size,
                       cfg.max_rays_in_flight))
    return Context(configuration=cfg, device=device)


def destroy(context: Context) -> None:
    """Counterpart of ``rayaccel_tpu/context.py:destroy``: tensors are freed
    with their last reference, there is nothing to join."""


def info(context: Context) -> ContextInfo:
    """Counterpart of ``rayaccel_tpu/context.py:info``. The port runs on
    one device (no mesh), so ``device_count`` is 1."""
    cfg = context.configuration
    return ContextInfo(device_count=1, wave_size=cfg.wave_size,
                       max_rays_in_flight=cfg.max_rays_in_flight,
                       backend=cfg.backend)
