"""BENCHMARK.json against the contract's form, and the harness's discovery
of configurations, traffic mixes, traffic kinds, limits and metric readers
by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

import torch

from benchmark.bench import check, spec, traffic

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark(ROOT)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in bench["configs"]] + [c["source"] for c in bench["configs"]]
                 + [w["why"] for w in bench["workloads"]] + [m["layer"] for m in bench["per_layer"]]
                 + bench["command"]):
        assert LINE.match(text), text
    assert len(json.dumps(bench)) < 64 * 1024


def test_entries_keep_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_is_whole(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench, ROOT)
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e and m["moves"] in reported, (w["name"], m["name"])
            assert callable(spec.metric_reader(m["name"]))
        prefix = spec.kind(cell["traffic"]["kind"]).ANSWER
        assert cell["limits"] and set(cell["limits"]) <= {f"{prefix}_rel_l2", f"{prefix}_max_abs"}


def test_added_files_are_found_without_an_edit(tmp_path, bench):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads(json.dumps(bench))
    bd = tmp_path / "benchmark"
    cfg = json.loads((ROOT / b["configs"][0]["file"]).read_text())
    cfg["problem"]["npix"] = 301
    (bd / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (bd / "traffic" / "new-mix.json").write_text(json.dumps({"kind": "cg_solve", "maximum_iterations": 7}))
    (bd / "limits" / "new-config.new-mix.json").write_text(json.dumps({"x_rel_l2": 1, "x_max_abs": 1}))
    (bd / "metrics" / "new.metric.py").write_text("def read(t):\n    return 42.0\n")
    b["configs"].append({"name": "new-config", "source": "https://example.org", "reduced": [],
                         "file": "benchmark/configs/new-config.json", "why": "new"})
    b["workloads"].append({"name": "new-config.new-mix", "config": "new-config", "traffic": "new-mix",
                           "chips": 1, "why": "new"})
    b["per_layer"].append({"name": "new.metric", "unit": "%", "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "cg_ms_per_iter", "workloads": ["new-config.new-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.cell("new-config.new-mix", root=tmp_path, bench_dir=bd)
    assert cell["config"]["problem"]["npix"] == 301
    assert cell["traffic"]["maximum_iterations"] == 7
    assert [m["name"] for m in cell["per_layer"]][-1] == "new.metric"
    assert spec.metric_reader("new.metric", bd)(None) == 42.0


KIND = """ANSWER = "z"


class Work:
    def __init__(self, model, x, config, traffic, stages, seed):
        self.args = (model, x, config, traffic, stages, seed)


WORK = Work


def reference(config, traffic, x, device):
    return 2 * x
"""


def test_a_kind_is_found_by_its_name(tmp_path):
    (tmp_path / "kinds").mkdir()
    (tmp_path / "kinds" / "new_kind.py").write_text(KIND)
    assert spec.kind("new_kind", tmp_path).ANSWER == "z"
    mix = {"kind": "new_kind"}
    work = traffic.make("model", "x", {}, mix, None, 7, tmp_path, capture=print)  # a kwarg it does not take
    assert work.args == ("model", "x", {}, mix, None, 7)
    assert torch.equal(check.reference_answer({}, mix, torch.ones(2), "cpu", tmp_path), torch.full((2,), 2.0))
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path / "kinds" / "no_such_kind.py"))):
        spec.kind("no_such_kind", tmp_path)
    with pytest.raises(FileNotFoundError, match="no_such_kind"):
        traffic.make(None, None, {}, {"kind": "no_such_kind"}, None, 7, tmp_path)
