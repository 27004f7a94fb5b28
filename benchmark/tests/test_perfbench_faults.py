"""A run driven end to end on the CPU at a toy size, the look for a card
skipped: sound, `correct` comes out true; with the timed path broken
underneath, false.  The faults a one-card cell can have: a step that
returns its state unchanged, half of the bands left out and the rest
counted twice, an answer altered where it is produced."""

import types

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.bench import program, spec
from benchmark.bench.yardstick import apply_chain

SEED = 2**31 + 5  # past 32 signed bits, as the driver's seeds may be
TOY = dict(npix=101, bands=["1c", "2c"], n_pointings=2, lambda_subsample=9)
# limits for this toy size (its gaps are not the cell's): well above the
# sound runs' readings here (rank conv truncated, float32 on the CPU)
TOY_LIMITS = {"cg_solve": {"x_rel_l2": 1e-3, "x_max_abs": 1e-2},
              "normal_chain": {"g_rel_l2": 1e-3, "g_max_abs": 1e-3}}


def toy_cell(workload):
    cell = spec.cell(workload)
    cell["config"]["problem"].update(TOY)
    cell["limits"] = TOY_LIMITS[cell["traffic"]["kind"]]
    if cell["traffic"]["kind"] == "cg_solve":
        cell["traffic"]["maximum_iterations"] = 5
    return cell


class EagerChain:
    """The captured chain's stand-in on the CPU, where no CUDA graph can be
    made: each replay runs the chain eagerly into the same output."""

    def __init__(self, model, x0, chain):
        self.model, self.x0, self.chain = model, x0, chain
        self.g = apply_chain(model, x0, chain)

    def replay(self):
        self.g.copy_(apply_chain(self.model, self.x0, self.chain))


def eager_capture(model, x0, chain):
    graph = EagerChain(model, x0, chain)
    return graph, graph.g


def drive(cell, trace=0):
    args = types.SimpleNamespace(seed=SEED, seconds=0.2, trace=trace)
    return run.run_cell(args, torch.device("cpu"), cell, capture=eager_capture, clock=lambda: 0.0)


def _half_bands(Spectro):
    forward = Spectro.forward

    def masked(self, x, plain=False):
        y = forward(self, x, plain).clone()
        for c in range(len(self.channels)):
            block = y[int(self._idx[c]) : int(self._idx[c + 1])]
            block.mul_(2.0 if c % 2 == 0 else 0.0)
        return y

    return {"forward": masked, "normal": lambda self, x, plain=False: self.adjoint(masked(self, x, plain), plain)}


def _altered(Spectro):
    adjoint = Spectro.adjoint

    def adj(self, y, plain=False):
        out = adjoint(self, y, plain).clone()
        out.view(-1)[123] += out.abs().max()
        return out

    return {"adjoint": adj}


FAULTS = {
    "unchanged": {"normal_chain": lambda S: {"forward": lambda self, x, plain=False: self._x(x),
                                              "adjoint": lambda self, y, plain=False: y}},
    "half_bands": {"normal_chain": _half_bands, "cg_solve": _half_bands},
    "altered": {"normal_chain": _altered},
}


def _unchanged_lcg(normal_op, b, x0, **kw):
    from surfh_tpu_torch.solvers.cg import SolverResult

    return SolverResult(x=x0, grad_norm=np.zeros(1), n_iter=kw["max_iter"], converged=False)


def _altered_run_method(run_method):
    def rm(self, *a, **kw):
        res = run_method(self, *a, **kw)
        res.x = res.x.clone()
        res.x.view(-1)[4321] += res.x.abs().max()
        return res

    return rm


@pytest.fixture(autouse=True)
def one_process(monkeypatch):
    monkeypatch.setattr(program, "WORKERS", 1)


@pytest.mark.parametrize("workload", ["flagship-wplane-banded.cg50", "flagship-rank.normal-graph"])
def test_sound_run_is_correct(workload):
    res = drive(toy_cell(workload))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["flagship-wplane-banded.cg50", "flagship-rank.normal-graph"])
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    from surfh_tpu_torch.models.spectro import SpectroSigRLSCT
    from surfh_tpu_torch.solvers import criterion

    cell = toy_cell(workload)
    kind = cell["traffic"]["kind"]
    if kind == "cg_solve" and fault == "unchanged":
        monkeypatch.setattr(criterion, "lcg", _unchanged_lcg)
    elif kind == "cg_solve" and fault == "altered":
        monkeypatch.setattr(criterion.QuadCriterion_MRS, "run_method",
                            _altered_run_method(criterion.QuadCriterion_MRS.run_method))
    else:
        for name, fn in FAULTS[fault][kind](SpectroSigRLSCT).items():
            monkeypatch.setattr(SpectroSigRLSCT, name, fn)
    res = drive(cell)
    assert not res["correct"], res["checks"]


def test_a_traced_run_reads_its_metrics_and_stays_correct():
    cell = toy_cell("flagship-wplane-banded.cg50")
    res = drive(cell, trace=1)
    assert res["correct"]
    assert res["metrics"]["solver.syncs_per_iter"]["value"] > 0
    assert set(res["extra"]) == {"busy_s", "window_s", "breakdown"}
