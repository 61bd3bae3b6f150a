"""The check fails the control (the program at precision="default": its
bf16 variants) and each fault planted under the timed path."""

from __future__ import annotations

import pytest

from rtbench import faults
from rtbench.tests.conftest import CELLS, tiny_run


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_fails(cell):
    result, numbers = tiny_run(
        cell, overrides={"config": {"configuration": {"precision": "default"}}})
    assert not result["correct"]
    assert numbers["differ_pct"]["value"] > numbers["differ_pct"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_fails(cell, fault):
    result, numbers = tiny_run(cell, fault=faults.FAULTS[fault])
    assert not result["correct"], numbers
