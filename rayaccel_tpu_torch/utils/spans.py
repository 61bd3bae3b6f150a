"""Named ranges inside a frame, for ``torch.profiler`` and Nsight Systems.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler is on (``torch.profiler.profile``, or ``emit_nvtx``, which
turns each range into an NVTX range), and one shared null context
otherwise, so that a frame run without a profiler pays a function call
a span and nothing more. A span launches no kernel, reads nothing back
and changes no result.

Names are ``racc.<layer>.<what>``, the layer one of ``render``,
``dense``, ``sparse`` and ``shade``; every span lies inside
``racc.render.frame``. ``racc.<layer>.read.<site>`` marks a place where
the host waits for the device (a count read back, a ``nonzero``, a
boolean-mask index, an upload of a small host array).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range called ``name`` while a profiler is
    on; otherwise a null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
