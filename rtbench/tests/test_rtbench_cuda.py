"""One short run of the headline cell on the card, as the driver runs it;
skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from rtbench import run


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_device):
    proc = subprocess.run(
        [sys.executable, "-m", "rtbench.run", "--workload", "pt.d2",
         "--seed", "4294967311", "--seconds", "3", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
