"""The port's device rule: its public constructors and contexts put their
tensors on the current CUDA device unless the caller names another, and
never pick the CPU by themselves."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA device.
    With no CUDA device visible and no ``device`` this raises
    ``RuntimeError``: pass ``device="cpu"`` to run the plain versions on the
    host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: pass "
                               "device=\"cpu\" to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def to_device(tree, device):
    """A NamedTuple of tensors (a compiled scene, an environment) with every
    tensor on ``device``: ``tree`` itself when they all are there."""
    if all(a.device == device for a in tree):
        return tree
    return type(tree)(*(a.to(device) for a in tree))
