"""`scripts/torch_scatter_proto.py` and `surfh_tpu_torch.utils.profiling` on
the CPU.

* the script with ``--cpu`` at a 201² sky exits 0, imports no JAX and
  nothing of `surfh_tpu`, and its K1/K2/K3 agree with the COO transpose to
  ≤1e-6 (the plain versions sum the same taps in the same order);
* `run_proto` returns the shapes and checks of a port channel;
* `chained_time` chains dependent applications and times them on the host
  clock here; `PhaseTimer` accumulates named phases; `trace` writes a
  Chrome trace.
"""

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from surfh_tpu_torch.utils import profiling

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def test_script_on_the_cpu_checks_and_imports_no_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['torch_scatter_proto.py', '--cpu', '--npix', '201']\n"
        "runpy.run_path('scripts/torch_scatter_proto.py', run_name='__main__')\n"
    )
    # run_path's SystemExit(0) ends the interpreter before any check placed
    # after it, so the import check rides on an exit hook
    guard = (
        "import atexit, sys\n"
        "def _clean():\n"
        "    bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'surfh_tpu' or m.startswith('surfh_tpu.')]\n"
        "    print('imports:', 'clean' if not bad else bad)\n"
        "atexit.register(_clean)\n"
    )
    proc = subprocess.run([sys.executable, "-c", guard + code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "imports: clean" in proc.stdout, proc.stdout
    head = re.search(r"band 1c: P=(\d+)->(\d+) n_out=(\d+) W=(\d+) L=(\d+)", proc.stdout)
    assert head, proc.stdout
    P, Pp, n_out, W, L = map(int, head.groups())
    assert Pp % 512 == 0 and Pp >= P and W == 466 and 1 <= L <= 32
    checks = dict(re.findall(r"check (\w+): max rel (\S+)", proc.stdout))
    assert {"K1", "K2", "K3"} <= set(checks), proc.stdout
    assert all(float(checks[k]) <= 1e-6 for k in ("K1", "K2", "K3")), checks
    assert "correctness only" in proc.stdout


def test_run_proto_on_a_port_channel():
    spec = importlib.util.spec_from_file_location("torch_scatter_proto",
                                                  ROOT / "scripts" / "torch_scatter_proto.py")
    proto = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proto)
    from surfh_tpu_torch.instrument.geometry import get_srf
    from surfh_tpu_torch.models.channel import Channel
    from surfh_tpu_torch.simulation.flagship import make_flagship_setup

    s = make_flagship_setup(npix=201, bands=["1b"], n_pointings=1)
    instr = s["instrs"][0]
    chan = Channel(instr, s["alpha_axis"], s["beta_axis"], s["wavelength_axis"],
                   get_srf([instr.det_pix_size], s["step_degree"] * 3600)[0], s["pointings"][0],
                   s["step_degree"])
    lines = []
    out = proto.run_proto(chan, "cpu", tp=64, band="1b", log=lines.append)
    assert out["P"] == chan.tbbox[2] * chan.tbbox[3] and out["W"] == chan.n_wslice
    assert out["Pp"] % 64 == 0 and out["padded_over_nnz"] >= 1.0 and "ms" not in out
    assert max(out["check"][k] for k in ("K1", "K2", "K3", "CSR")) <= 1e-6
    assert out["check"]["library"] <= 1e-5
    assert lines[0].startswith("band 1b:") and len(lines) == 7 and out["L"] <= 32


def test_chained_time_runs_a_dependent_chain():
    calls = []

    def fn(x):
        calls.append(float(x.sum()))
        return 1e30 * x

    x = torch.ones(8, dtype=torch.float64)
    t = profiling.chained_time(fn, x, chain=3, reps=2)
    assert np.isfinite(t) and t > 0
    assert len(calls) == 3 * 3  # one warm-up chain and two timed
    # each input is x + 1e-30 · (the sum of the outputs so far): 8, 8 + 8·8, ...
    assert calls[:3] == pytest.approx([8.0, 72.0, 8.0 + 8 * (8.0 + 72.0)], rel=1e-12)
    assert calls[3:6] == calls[:3]


def test_phase_timer_and_trace(tmp_path):
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer("a"):
            sum(range(1000))
    with timer("b"):
        pass
    assert timer.counts == {"a": 3, "b": 1} and timer.totals["a"] > 0
    rows = timer.summary().splitlines()
    assert rows[0].startswith("phase") and len(rows) == 3
    timer.reset()
    assert not timer.totals and not timer.counts
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert prof is not None and (tmp_path / "tr" / "trace.json").stat().st_size > 0
