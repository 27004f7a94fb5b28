"""The control: the reference in float32 with TF32 operands, put in the
program's place, has to come out as not correct.

On the CPU at a small size (a 201² sky, which holds the two bands' fields
of view; 5 CG iterations) it has to read at least three times what the
sound program reads there; on the card (``-m cuda``) at the cell's own
size it has to fail the cell's committed limits."""

import pytest
import torch

from benchmark import control
from benchmark.bench import program, spec

from test_perfbench_faults import SEED, drive, toy_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def one_process(monkeypatch):
    monkeypatch.setattr(program, "WORKERS", 1)


@pytest.mark.parametrize("workload", ["flagship-wplane-banded.cg50", "flagship-rank.normal-graph"])
def test_control_reads_above_the_sound_program(workload):
    cell = toy_cell(workload)
    cell["config"]["problem"]["npix"] = 201
    sound = drive(cell)["checks"]
    ctl = {r["reading"]: r for r in control.readings(cell, SEED, torch.device("cpu"))}["control"]
    assert any(ctl[name] >= 3 * n["value"] for name, n in sound.items()), (ctl, sound)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_cell_limits_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    cell = spec.cell(workload)
    ctl = {r["reading"]: r for r in control.readings(cell, 7, torch.device("cuda", 0))}["control"]
    assert any(ctl[name] > limit for name, limit in cell["limits"].items()), (ctl, cell["limits"])
