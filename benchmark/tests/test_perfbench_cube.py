"""A configuration whose unknown is the cube, added as files alone (its
configuration, traffic mix and limits, and its entries in a copy of
`BENCHMARK.json`) and driven end to end on the CPU at a toy size, the look
for a card skipped: sound, `correct` comes out true; with one band left out
of the program's output, false."""

import json
import shutil
import types
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.bench import program, spec

from test_perfbench_faults import SEED

ROOT = Path(__file__).resolve().parents[2]
TOY = dict(npix=101, bands=["1c", "2c"], n_pointings=2, lambda_subsample=9, unknown="cube")
# limits for this toy size: well above the sound run's readings here (float32 on the CPU)
TOY_LIMITS = {"x_rel_l2": 1e-4, "x_max_abs": 1e-3}


@pytest.fixture(autouse=True)
def one_process(monkeypatch):
    monkeypatch.setattr(program, "WORKERS", 1)


@pytest.fixture(scope="module")
def cube_cell(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bd = root / "benchmark"
    bench = spec.load_benchmark(ROOT)
    cfg = json.loads((ROOT / "benchmark" / "configs" / "flagship-wplane-banded.json").read_text())
    cfg["problem"].update(TOY)
    (bd / "configs" / "toy-cube.json").write_text(json.dumps(cfg))
    mix = json.loads((bd / "traffic" / "cg50.json").read_text())
    (bd / "traffic" / "cg5.json").write_text(json.dumps(dict(mix, maximum_iterations=5)))
    (bd / "limits" / "toy-cube.cg5.json").write_text(json.dumps(TOY_LIMITS))
    bench["configs"].append({"name": "toy-cube", "source": "https://example.org", "reduced": [],
                             "file": "benchmark/configs/toy-cube.json", "why": "the cube unknown"})
    bench["workloads"].append({"name": "toy-cube.cg5", "config": "toy-cube", "traffic": "cg5", "chips": 1,
                               "why": "the cube unknown"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "flagship-wplane-banded.cg50" in m.get("workloads", []):
            m["workloads"].append("toy-cube.cg5")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return lambda: spec.cell("toy-cube.cg5", root=root, bench_dir=bd)


def drive(cell):
    args = types.SimpleNamespace(seed=SEED, seconds=0.2, trace=0)
    return run.run_cell(args, torch.device("cpu"), cell, clock=lambda: 0.0)


def _drop_band(forward):
    """The forward with the first band's data left out, and its normal."""
    def dropped(self, x, plain=False):
        y = forward(self, x, plain).clone()
        y[int(self._idx[0]) : int(self._idx[1])] = 0
        return y

    return {"forward": dropped, "normal": lambda self, x, plain=False: self.adjoint(dropped(self, x, plain), plain)}


def test_a_cube_cell_from_files_alone_is_correct(cube_cell):
    cell = cube_cell()
    assert cell["config"]["problem"]["unknown"] == "cube"
    res = drive(cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "cg_ms_per_iter", "peak_gib"}


def test_a_cube_cell_missing_a_band_is_not_correct(cube_cell, monkeypatch):
    from surfh_tpu_torch.models.spectro import SpectroSigRLSCT

    for name, fn in _drop_band(SpectroSigRLSCT.forward).items():
        monkeypatch.setattr(SpectroSigRLSCT, name, fn)
    res = drive(cube_cell())
    assert not res["correct"], res["checks"]
