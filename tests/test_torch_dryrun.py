"""The port's dry run (``rayaccel_tpu_torch/tools/dryrun.py``) against
``__graft_entry__.py``, on the CPU.

- ``entry(device="cpu")``'s frame step against ``entry()``'s on the same
  inputs: the radiance through the two-class gate of
  ``tools/oracle_lib.py:run_image_oracle`` (``rmse_trimmed < 1e-3``,
  ``frac_flip < 0.5%``), ``traced`` within 0.5%, ``dropped`` 0;
- ``dryrun_multichip(2)`` of both: the port's two gloo ranks print both
  lines, and the rays traced of the first sharded step are within 0.5% of
  JAX's (two devices of conftest's eight-device CPU mesh). Two ranks, not
  eight, keep the suite's gloo load small.

``__graft_entry__`` imports only numpy at module level, so importing it
here is safe.
"""

import re

import numpy as np

import jax

import __graft_entry__ as jax_entry
from rayaccel_tpu_torch.tools import dryrun
from rayaccel_tpu_torch.tools.oracle_lib import two_class_gate

TRACED_TOL = 0.005      # relative, port against JAX


def test_entry_step_matches_jax():
    fn, args = dryrun.entry(device="cpu")
    jfn, jargs = jax_entry.entry()
    for got, want in zip(args[:3], jargs[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(np.array(args[3], np.uint32), np.asarray(jargs[3]))
    rad, traced, dropped = fn(*args)
    jrad, jtraced, _ = jax.jit(jfn)(*jargs)
    assert rad.shape == jrad.shape == (2, 2048, 3)
    alive = args[2].numpy().ravel()
    gate = two_class_gate(rad.numpy().reshape(-1, 3)[alive],
                          np.asarray(jrad).reshape(-1, 3)[alive])
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate
    assert abs(int(traced) - int(jtraced)) <= TRACED_TOL * int(jtraced)
    assert int(traced) >= alive.sum() and int(dropped) == 0


def _printed(out):
    mrays = re.search(r"^MULTICHIP_MRAYS=([0-9.]+)$", out, re.M)
    ok = re.search(r"^dryrun_multichip OK: (\d+) devices, (\d+) rays "
                   r"traced, radiance \((\d+), (\d+), (\d+)\)$", out, re.M)
    assert mrays and ok, out
    return float(mrays.group(1)), [int(g) for g in ok.groups()]


def test_dryrun_multichip_matches_jax(capsys):
    dryrun.dryrun_multichip(2)
    port = capsys.readouterr().out
    jax_entry.dryrun_multichip(2)
    ref = capsys.readouterr().out
    mrays, (n, traced, *shape) = _printed(port)
    _, (jn, jtraced, *jshape) = _printed(ref)
    assert mrays > 0 and (n, shape) == (jn, jshape) == (2, [2, 2048, 3])
    assert abs(traced - jtraced) <= TRACED_TOL * jtraced
    assert re.search(r"^MULTICHIP_DROPPED=0$", port, re.M), port
