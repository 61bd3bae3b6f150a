"""The frame and wave functions' default engine, a decided difference
between the packages: the port's default ``backend`` is "pallas" (its
kernel path; on the CPU the kernels' plain versions), the JAX package's
"mxu" (in the port the plain ``torch.bmm`` engine). Each default is
pinned here. Calls that leave ``backend`` out are held against the JAX
package's "pallas" calls in ``test_torch_frame.py`` (``pt_trace_frame``),
``test_torch_wave.py`` (``pt_trace_wave``) and ``test_torch_whitted.py``
(``whitted_trace_frame``; ``whitted_trace_wave`` against that frame)."""

import inspect

import pytest

from rayaccel_tpu.render import pathtracer as jax_pt
from rayaccel_tpu.render import whitted as jax_whitted

from rayaccel_tpu_torch.render import pathtracer, whitted

FUNCTIONS = {
    "pt_trace_wave": (pathtracer, jax_pt),
    "pt_trace_frame": (pathtracer, jax_pt),
    "whitted_trace_wave": (whitted, jax_whitted),
    "whitted_trace_frame": (whitted, jax_whitted),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_default_engine_is_pallas_and_the_jax_default_mxu(name):
    port, jax_module = FUNCTIONS[name]
    for module, want in ((port, "pallas"), (jax_module, "mxu")):
        params = inspect.signature(getattr(module, name)).parameters
        assert params["backend"].default == want
