"""The port's headline-measurement scripts on the CPU against the unmodified
JAX scripts, each run as a subprocess at the size of
`tests/test_kernels.py`'s flagship fixture (band 4c, 41², 2 pointings):
`scripts/torch_flagship_cg.py` against `scripts/flagship_cg.py`,
`scripts/torch_quality_surface.py` against `scripts/quality_surface.py`,
and `scripts/torch_rank_fidelity_audit.py` against
`scripts/rank_fidelity_audit.py` (band 1c at 201², where its FOV lies
inside the sky).

Tolerances, measured here and why.  Off the TPU the JAX scripts resolve
``conv_impl="auto"`` to the window's FFT conv (`build_sotf=True`); the
port's flagship is the λ-rank matmul conv (``conv_rank_rtol`` 1e-7,
``conv_freq_rtol`` 1e-6) on every device.  So the two scripts run two
spellings of the conv, both in float32:

* ‖r₀‖ = ‖b − A·x₀‖ (`grad_norm_marks["0"]`): 4.2e-4 apart.  The rank
  truncation (SVD tail 1.5e-8) passes through r₀'s cancellation,
  b = Hᵗy against A·0.5; with the dense window-local conv
  (``SURFH_CONV_RANK_RTOL=0``) the gap is 2.2e-5.  Bound 1e-3.
* `relative_error_pct` after 5 iterations: 1.2e-4 apart.  Bound 1e-3.
* The sweep's `rel_err_pct` and `psnr` after 5 iterations: up to 9.6e-4
  and 6.4e-4 apart (the noisy rows).  Float32 CG amplifies the two
  spellings' difference with each iteration: the gradient norms of the
  two packages agree to 3e-3 up to iteration 4 and part at 5 on this
  problem.  Bound 3e-3 on both.
* The audit compares no solve: both packages find the same ranks and SVD
  tails (host float64, 1e-9), and both float32 deviations lie within the
  port script's bound, max(10 × tail, 2e-5) (measured 1.7e-5 / 1.6e-5 on
  the forward)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--bands", "4c", "--npix", "41", "--pointings", "2"]


# The JAX scripts write to fixed paths: the XLA compile cache
# (`/tmp/surfh_jax_cache`) and the audit's record (`OUT`).  They run
# unmodified through this wrapper, which sends both under the test's TMPDIR
# before calling the script's `main`.
_JAX_SCRIPT = """\
import importlib.util, os, sys
import jax
tmp = os.environ["TMPDIR"]
_update = jax.config.update
def _update_under_tmp(name, value):
    _update(name, os.path.join(tmp, "jax_cache") if name == "jax_compilation_cache_dir" else value)
jax.config.update = _update_under_tmp
sys.argv = sys.argv[1:]
spec = importlib.util.spec_from_file_location("jax_script", sys.argv[0])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
if hasattr(mod, "OUT"):
    mod.OUT = os.path.join(tmp, "jax_out", os.path.basename(mod.OUT))
mod.main()
"""


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(SURFH_TABLE_CACHE="0", SURFH_CACHE_DIR=str(tmp_path / "cache"), TMPDIR=str(tmp_path),
               HOME=str(tmp_path), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    return env


def _run(tmp_path, script, *args, rc=0):
    """Run `scripts/<script>`: a port script as a user runs it, a JAX script
    through `_JAX_SCRIPT`."""
    cmd = [sys.executable, f"scripts/{script}", *args]
    if not script.startswith("torch_"):
        cmd[1:1] = ["-c", _JAX_SCRIPT]
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(tmp_path), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == rc, (script, proc.stderr[-3000:])
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_flagship_cg_matches_the_jax_script(tmp_path):
    want = _run(tmp_path, "flagship_cg.py", "--cpu", "--niter", "5", *SMALL)[-1]
    got = _run(tmp_path, "torch_flagship_cg.py", "--cpu", "--niter", "5", *SMALL)[-1]
    assert set(want) <= set(got)
    assert got["solver_loop"] == "graph" and got["device"] == "cpu"
    for k in ("method", "mu", "niter", "n_channels", "cube_shape"):
        assert got[k] == want[k], k
    assert sorted(got["grad_norm_marks"]) == sorted(want["grad_norm_marks"]) == ["0"]
    assert _rel(got["grad_norm_marks"]["0"], want["grad_norm_marks"]["0"]) <= 1e-3
    assert _rel(got["relative_error_pct"], want["relative_error_pct"]) <= 1e-3
    assert got["grad_reduction"] > 1 and got["iters_per_s"] > 0


def test_flagship_cg_dispatch_loop_iterates_as_the_graph_loop(tmp_path):
    """`--solver-loop dispatch` (the JAX script's loop) and the default
    graph loop run the same iterates: the same report, bit for bit."""
    graph = _run(tmp_path, "torch_flagship_cg.py", "--cpu", "--niter", "3", *SMALL)[-1]
    disp = _run(tmp_path, "torch_flagship_cg.py", "--cpu", "--niter", "3",
                "--solver-loop", "dispatch", "--chain", "2", *SMALL)[-1]
    assert disp["solver_loop"] == "dispatch"
    for k in ("grad_norm_final", "grad_norm_marks", "relative_error_pct", "niter"):
        assert disp[k] == graph[k], k


def test_quality_surface_matches_the_jax_script(tmp_path):
    sweep = ["--cpu", "--niter", "5", "--mus", "5e3,5e8", "--noise", "0,0.01",
             "--scenes", "orion,ngc7023", *SMALL]
    want = _run(tmp_path, "quality_surface.py", *sweep)
    out = tmp_path / "q.json"
    got = _run(tmp_path, "torch_quality_surface.py", *sweep, "--out", str(out))
    assert len(got) == len(want) == 2 * 2 * 2 + 1
    for g, w in zip(got[:-1], want[:-1]):
        assert set(g) == set(w)
        assert (g["scene"], g["noise_frac"], g["mu"], g["niter"]) == (
            w["scene"], w["noise_frac"], w["mu"], w["niter"])
        assert _rel(g["rel_err_pct"], w["rel_err_pct"]) <= 3e-3, (g, w)
        assert _rel(g["psnr"], w["psnr"]) <= 3e-3, (g, w)
    best = [(b["scene"], b["noise_frac"]) for b in got[-1]["summary"]]
    assert best == [(b["scene"], b["noise_frac"]) for b in want[-1]["summary"]]
    saved = json.loads(out.read_text())
    assert saved["rows"] == got[:-1] and saved["best"] == got[-1]["summary"]
    assert saved["config"]["device"] == "cpu"


def test_rank_fidelity_audit_matches_the_jax_script(tmp_path):
    dims = ["--bands", "1c", "--npix", "201", "--pointings", "2"]
    want = _run(tmp_path, "rank_fidelity_audit.py", "--phase", "deviation", *dims)[-1]
    got = _run(tmp_path, "torch_rank_fidelity_audit.py", "--phase", "deviation", "--cpu",
               "--out-dir", str(tmp_path / "audit"), *dims)[-1]
    assert set(want) <= set(got)
    assert got["ranks"] == want["ranks"] and all(r is not None for r in got["ranks"])
    for a, b in zip(got["svd_tails"], want["svd_tails"]):
        assert _rel(a, b) <= 1e-9
    assert got["bound"] == max(10 * got["max_tail"], 2e-5)
    assert got["within_bound"]
    assert max(want["fwd_max_rel"], want["adj_max_rel"]) <= got["bound"]
    assert json.loads((tmp_path / "jax_out" / "rank_audit.json").read_text())["ranks"] == want["ranks"]
    saved = json.loads((tmp_path / "audit" / "rank_audit.json").read_text())
    assert saved["ranks"] == got["ranks"]


def test_rank_fidelity_audit_cg_phases_cross_compare(tmp_path):
    """The CG phases save each mode's solution; the second one run compares
    the two (f32 solves of two spellings of one operator, 3 iterations)."""
    args = ["--phase", "cg", "--cpu", "--niter", "3", "--out-dir", str(tmp_path / "a"), *SMALL]
    rank = _run(tmp_path, "torch_rank_fidelity_audit.py", *args, "--rank-mode", "rank")[-1]
    dense = _run(tmp_path, "torch_rank_fidelity_audit.py", *args, "--rank-mode", "dense")[-1]
    assert rank["cg_rank"]["niter"] == dense["cg_dense"]["niter"] == 3
    assert "cg_cross" not in rank
    assert dense["cg_cross"]["x_max_rel"] <= 1e-2
    assert _rel(rank["cg_rank"]["relative_error_pct"], dense["cg_dense"]["relative_error_pct"]) <= 1e-3
    assert (tmp_path / "a" / "x_rank.npy").exists() and (tmp_path / "a" / "x_dense.npy").exists()


@pytest.mark.parametrize("script", ["torch_flagship_cg.py", "torch_quality_surface.py",
                                    "torch_rank_fidelity_audit.py"])
def test_scripts_need_the_card_unless_asked(tmp_path, script):
    env = _env(tmp_path)
    env["CUDA_VISIBLE_DEVICES"] = ""
    args = ["--phase", "deviation"] if "audit" in script else []
    proc = subprocess.run([sys.executable, f"scripts/{script}", *args, *SMALL], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
