"""`bench_torch.py`, the port's counterpart of `bench.py`, against it on the
CPU: the same presets, the same analytic FLOP count on the same models, the
timed chain ``g = adjoint(forward(x))`` to ≤1e-12 in float64 against the
JAX model's, the result line's keys and its baseline arithmetic, the
baseline note for a preset the file lacks, and no result without a card
unless SURFH_BENCH_CPU asks for the CPU.  The CUDA-graph chain is tested on
the card (`tests/test_torch_kernels_cuda.py`)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402  (the JAX round's bench: its module level imports no JAX)
import bench_torch  # noqa: E402

RESULT_KEYS = {
    "metric", "value", "unit", "vs_baseline", "preset", "t_app_s", "t_compile_s",
    "compile_breakdown", "flops_per_app", "tflops", "mfu_est", "mfu_note", "cube_shape",
    "n_channels", "n_pointings", "baseline_s", "baseline_config", "device_ms_per_app",
    "dispatch_ms_per_app", "device_busy_frac", "t_total_s", "mode", "device",
}


def _run_bench(tmp_path, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SURFH_BENCH") and k != "PYTHONPATH"}
    env.update(SURFH_TABLE_CACHE="0", TMPDIR=str(tmp_path), **env_extra)
    return subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_presets_are_bench_py_s():
    assert bench_torch.PRESETS == bench.PRESETS


@pytest.mark.parametrize("preset", ["small", "medium"])
def test_analytic_flops_equal_bench_py_s(preset):
    """The same count on the two packages' models of one preset."""
    from surfh_tpu.simulation.synthetic import make_model as jax_make_model
    from surfh_tpu_torch.simulation.synthetic import make_model

    jm, _ = jax_make_model(dtype=jnp.float32, **bench.PRESETS[preset])
    pm, _ = make_model(dtype=np.float32, **bench_torch.PRESETS[preset])
    flops = bench_torch._analytic_flops(pm)
    assert flops > 0
    assert flops == bench._analytic_flops(jm)


def test_timed_chain_matches_jax_float64():
    """Two dependent applications x = x0 + g·1e-30, g = Hᵗ(H x), of the
    `small` preset in float64: ≤1e-12 relative to the JAX model's."""
    from surfh_tpu.simulation.synthetic import make_model as jax_make_model
    from surfh_tpu_torch.simulation.synthetic import make_model

    jm, jsetup = jax_make_model(dtype=jnp.float64, **bench.PRESETS["small"])
    pm, _ = make_model(dtype=np.float64, **bench_torch.PRESETS["small"])
    pm.to("cpu", torch.float64)
    x0 = np.asarray(jsetup["maps"], np.float64)
    g = bench_torch.apply_chain(pm, torch.as_tensor(x0), chain=2)
    x = jnp.asarray(x0)
    for _ in range(2):
        want = jm.adjoint_fn(jm._forward_fn(x))
        x = jnp.asarray(x0) + want * 1e-30
    want = np.asarray(want)
    assert g.dtype == torch.float64 and g.shape == want.shape
    assert np.abs(g.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_cpu_run_prints_bench_py_s_line(tmp_path):
    """SURFH_BENCH_CPU=1, small, 1 rep of a 2-application chain: one JSON
    last line with every key, the recorded baseline's speedup, no device
    numbers on the CPU."""
    proc = _run_bench(tmp_path, SURFH_BENCH_CPU="1", SURFH_BENCH_PRESET="small",
                      SURFH_BENCH_REPS="1", SURFH_BENCH_CHAIN="2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[-1])
    assert RESULT_KEYS <= set(res)
    assert res["metric"] == "fwd+adjoint cube-op throughput (small)"
    assert res["preset"] == "small" and res["unit"] == "GVox/s" and res["mode"] == "dispatch"
    assert res["device"] == "cpu" and res["value"] > 0 and res["t_app_s"] > 0
    assert res["cube_shape"] == [60, 81, 81] and res["n_channels"] == 2 and res["n_pointings"] == 2
    assert res["value"] == pytest.approx(2 * 60 * 81 * 81 / res["t_app_s"] / 1e9, rel=1e-12)
    rec = json.loads((ROOT / "baseline_cpu.json").read_text())["small"]
    assert res["baseline_s"] == rec["seconds"] and res["baseline_config"] == rec["config"]
    assert res["vs_baseline"] == pytest.approx(rec["seconds"] / res["t_app_s"], rel=1e-12)
    cb = res["compile_breakdown"]
    assert {"host_build_s", "table_cache", "upload_mb", "tables_dispatch_s", "warmup_run_s"} <= set(cb)
    assert cb["table_cache"] == "off" and cb["upload_mb"] > 0
    assert res["t_compile_s"] == pytest.approx(
        sum(v for k, v in cb.items() if k.endswith("_s")), rel=1e-12)
    assert res["mfu_est"] == pytest.approx(res["tflops"] * 1e12 / 67e12, rel=1e-12)
    assert res["device_ms_per_app"] is None and res["device_busy_frac"] is None


@pytest.mark.parametrize("window_local", [False, True])
def test_rates_are_null_where_the_count_charges_a_conv_not_run(window_local):
    """The analytic count charges a full-grid FFT conv per band: `tflops`
    and `mfu_est` follow from it for the sotf models (small, medium) and
    are null for the window-local ones (large, flagship)."""
    got = bench_torch.rate_fields(6.7e12, 0.5, window_local)
    assert got["flops_per_app"] == 6.7e12 and got["flops_note"] == bench_torch.FLOPS_NOTE
    if window_local:
        assert got["tflops"] is None and got["mfu_est"] is None
        assert got["mfu_note"] == bench_torch.MFU_NOTE_WINDOW_LOCAL
    else:
        assert got["tflops"] == pytest.approx(13.4, rel=1e-12)
        assert got["mfu_est"] == pytest.approx(0.2, rel=1e-12)
        assert "not a device metric" in got["mfu_note"]


def test_busy_share_is_not_clamped():
    """bench.py's `dispatch_ms_per_app`; the busy share unclamped, and a
    note where the traced device time exceeds the timed window."""
    assert bench_torch.busy_fields(0.02, None) == {
        "device_ms_per_app": None, "dispatch_ms_per_app": None, "device_busy_frac": None}
    inside = bench_torch.busy_fields(0.02, 15.0)
    assert inside["dispatch_ms_per_app"] == pytest.approx(5.0, rel=1e-12)
    assert inside["device_busy_frac"] == pytest.approx(0.75, rel=1e-12)
    assert "device_busy_note" not in inside
    over = bench_torch.busy_fields(0.02, 21.0)
    assert over["device_busy_frac"] == pytest.approx(1.05, rel=1e-12)
    assert over["dispatch_ms_per_app"] == 0.0 and "above 1" in over["device_busy_note"]


def test_preset_missing_from_the_baseline_file_gets_bench_py_s_note(tmp_path, monkeypatch):
    path = tmp_path / "baseline_cpu.json"
    path.write_text(json.dumps({"small": {"seconds": 1.0, "config": "c"}}))
    monkeypatch.setattr(bench, "_BASELINE_FILE", str(path))
    monkeypatch.setattr(bench_torch, "_BASELINE_FILE", str(path))
    monkeypatch.delenv("SURFH_BENCH_SKIP_BASELINE", raising=False)
    want, got = {}, {}
    bench._attach_baseline(want, "medium", 0.5)
    bench_torch._attach_baseline(got, "medium", 0.5)
    assert got["vs_baseline"] is None and want["vs_baseline"] is None
    assert got["baseline_config"] == want["baseline_config"]
    assert "no recorded baseline for preset 'medium'" in got["baseline_config"]
    assert got["baseline_s"] is None
    bench._attach_baseline(want, "small", 0.5)
    bench_torch._attach_baseline(got, "small", 0.5)
    assert got["vs_baseline"] == want["vs_baseline"] == 2.0


def test_no_card_and_no_cpu_request_fails_naming_the_card(tmp_path):
    proc = _run_bench(tmp_path, SURFH_BENCH_PRESET="small", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_loop_mode_needs_the_card(tmp_path):
    """A CUDA graph has no CPU counterpart: the loop mode on the CPU fails
    before the build and prints no result."""
    proc = _run_bench(tmp_path, SURFH_BENCH_CPU="1", SURFH_BENCH_PRESET="small",
                      SURFH_BENCH_MODE="loop")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA graph" in proc.stderr
    assert bench_torch.bench_mode("small", torch.device("cpu")) == "dispatch"
    assert bench_torch.bench_mode("medium", torch.device("cuda")) == "loop"
    assert bench_torch.bench_mode("flagship", torch.device("cuda")) == "dispatch"
    assert bench_torch.bench_mode("large", torch.device("cuda")) == "dispatch"
