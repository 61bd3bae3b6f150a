"""Context lifecycle: counterpart of ``rayaccel_tpu/context.py``.

The port's context holds the configuration and one explicit
``torch.device``; every tensor the renderers create lives there. There is
no mesh: the multi-device tier is ROADMAP queue 1 item 15.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rayaccel_tpu_torch.config import Configuration, default_configuration


def init() -> None:
    """Pin fp32 arithmetic: the TPU kernels run ``Precision.HIGHEST``, so no
    float32 matrix product or convolution may drop to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Context:
    configuration: Configuration
    device: torch.device


def create_context(configuration: Optional[Configuration] = None,
                   device=None) -> Context:
    """Build a context on ``device`` (default: the current CUDA device when
    one is visible, else the CPU). Calls :func:`init`."""
    init()
    cfg = configuration or default_configuration()
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return Context(configuration=cfg, device=torch.device(device))
