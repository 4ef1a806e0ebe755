"""The reference against tmgcn_torch on the CPU at a tiny size: the first
steps and one evaluation agree within each cell's limits; the control (the
reference in TF32 in the port's place) and each fault planted in the port
come out not correct."""

import pytest
import torch

from benchmark import correctness, generator, harness, program
from benchmark.tests.tiny import cell, manifest

CELLS = [w["name"] for w in manifest()["workloads"]]
CPU = torch.device("cpu")


def _setup(name, tmp_path, seed=2**31 + 5):
    c, data_dir = cell(name, tmp_path)
    tr = c.traffic
    shapes = c.family.param_shapes(tr["features"], c.cfg["hidden_feat"], tr["labels"]["classes"])
    built, source = c.graph.port(c, seed, CPU, program.Spans(), data_dir)
    init = generator.initial_variables(shapes, generator.generator(seed, 2, CPU), CPU)
    wins = c.graph.reference_windows(c, source, CPU, data_dir)
    return c, built, init, wins


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_reference(name, tmp_path):
    c, built, init, wins = _setup(name, tmp_path)
    prog = c.drive.first_readings(c, built, init)
    numbers = correctness.readings(prog, c.drive.reference_readings(c, init, wins))
    correct, checks = correctness.judge(numbers, c.limits)
    assert correct, checks
    if "eval" in prog:
        assert set(prog["eval"][1]) == {"val", "test"}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tmp_path):
    c, _, init, wins = _setup(name, tmp_path)
    ref = c.drive.reference_readings(c, init, wins)
    control = c.drive.reference_readings(c, init, wins, tf32=True)
    correct, checks = correctness.judge(correctness.readings(control, ref), c.limits)
    assert not correct, checks


# Each cell's task names the faults its timed path can have.
FAULTS = [(n, f) for n in CELLS for f in harness.find_cell(manifest(), n).task.FAULTS]


@pytest.mark.parametrize(("name", "fault"), FAULTS)
def test_fault_in_the_timed_path_is_not_correct(name, fault, tmp_path):
    """The whole run but the look for a card, with the timed path broken."""
    c, data_dir = cell(name, tmp_path)
    with c.task.planted(fault):
        out = harness.run_cell(c, 99, 0.2, False, CPU, 0.0, data_dir=data_dir)
    assert not out["correct"], out["checks"]
