"""The control at a size a test run holds: the plain reference computed with
float8 operands, put in the program's place, has to come out not correct
under each cell's limits, where the program comes out correct."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.harness import cell, compare


@pytest.mark.parametrize("name", ["vga-batch16", "dense-fddb-450"])
def test_control_fails_where_the_program_passes(tiny_root, name):
    spec = cell.Spec(name, tiny_root)
    limits = {k: float(v) for k, v in spec.workload["limits"].items()}
    device = torch.device("cpu")
    rn, pool, det = cell.prepare(spec, 2**35 + 9, device)
    program = control.program_numbers(spec, rn, pool, det, device)
    low = control.control_numbers(rn, pool, det, device)
    assert compare.verdict(program, limits), program
    assert not compare.verdict(low, limits), low
