"""`BENCHMARK.json` and the files it names, found by name.

A configuration is ``configs/<name>.json`` (the path `BENCHMARK.json`
gives), a traffic mix ``traffic/<name>.json``, the limits of a cell's
comparison ``limits/<workload>.json``, a per-layer metric's reader
``metrics/<name>.py`` (a module with ``read(trace) -> float | None``), and
the traffic kind that a mix's ``"kind"`` names ``kinds/<kind>.py``, a
module with

* ``WORK(model, x, config, traffic, stages, seed)``: the units the window
  runs (``unit(index)``, ``units()``, ``sample``, ``free()``,
  ``unit_name``), from the program's model and the run's unknown `x`;
* ``ANSWER``: the letter of its answer in the limits' names (``x_rel_l2``);
* ``answer(op, x, config, traffic)``: what a kept answer should be, with
  the operator `op` (the plain reference, or a control in its place);
* ``reference(config, traffic, x, device)``: the answer of the float64
  plain reference;
* ``start(x, traffic)``: the unit's input state (the control's fault of a
  unit that returns its state unchanged).

Adding one is adding its file and its entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # benchmark/
ROOT = BENCH.parent  # the checkout


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def for_cell(metrics: list, workload: str) -> list:
    """The metrics a cell reports: those without a `workloads` list, and
    those whose list names the cell."""
    return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]


def cell(workload: str, bench: dict = None, root: Path = ROOT, bench_dir: Path = BENCH) -> dict:
    """Everything a run of `workload` reads: its entry, its configuration
    (the entry and the file's object), its traffic, its limits and its
    end-to-end and per-layer metrics."""
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if workload not in work:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {', '.join(work)}")
    w = work[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return {
        "workload": w,
        "config_entry": cfg,
        "config": _read_json(root / cfg["file"]),
        "traffic": _read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        "limits": _read_json(bench_dir / "limits" / f"{workload}.json"),
        "end_to_end": for_cell(bench["end_to_end"], workload),
        "per_layer": for_cell(bench["per_layer"], workload),
        "bench_dir": bench_dir,
    }


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH):
    """The `read` function of ``metrics/<name>.py``."""
    return _load(bench_dir / "metrics" / f"{name}.py", f"bench_metric_{name.replace('.', '_')}").read


def kind(name: str, bench_dir: Path = BENCH):
    """The module ``kinds/<name>.py`` of a traffic kind; raises where there is none."""
    path = bench_dir / "kinds" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic kind {name!r}: {path} does not exist")
    return _load(path, f"bench_kind_{name.replace('.', '_')}")
