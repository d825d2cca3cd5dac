"""A run end to end on the CPU at a small size: the reference's set
equals the program's, the result line has the contract's keys, the command
refuses to run without a card, the control and every fault the cells can
have come out not correct (``cell_checks``)."""

import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.cell_checks import (FAULTS, check_control, check_fault,
                                         check_run)
from portbench.tests.small import cells, small_cell


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", cells())
def test_reference_equals_the_program_on_the_cpu(name, trace):
    check_run(small_cell(name), trace)


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         cells()[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", cells())
def test_each_fault_is_not_correct(name, fault, monkeypatch):
    check_fault(small_cell(name), fault, monkeypatch)


@pytest.mark.parametrize("name", cells())
def test_the_control_is_not_correct(name):
    """The reference in bfloat16 in the program's place passes the limit
    on every step it checks, on three seeds."""
    check_control(small_cell(name))
