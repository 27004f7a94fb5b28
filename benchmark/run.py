#!/usr/bin/env python3
"""The benchmark of `surfh_tpu_torch` on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads `BENCHMARK.json` at the checkout's root and the files it names (see
`bench/spec.py`), builds the cell's configuration with the program, makes
the run's inputs from `--seed`, warms up (all of it `setup_s`), then runs
the traffic's units back to back for `--seconds` (the window closes at the
end of the unit in flight).  With ``--trace 0`` the result carries the
cell's end-to-end metrics; with ``--trace 1`` the first units of the
window run under `torch.profiler` and the result carries the per-layer
metrics, the device's busy seconds and a breakdown.  Once the window has
closed and the program's state is freed, the kept answers are compared
with the plain reference (`bench/check.py`), each number beside its limit
on the last lines of stderr and under `checks`, the last key of the
result, the one JSON line printed last on stdout.

Exits non-zero without a result where there is no card (or fewer than the
cell asks for), where the program cannot be imported, or where `jax`,
`jaxlib`, `flax` or `surfh_tpu` is loaded once the window has closed.
Caches: the host-table and spectral-response caches go to fixed
directories under ``.bench_cache/`` in the checkout; the program builds its
CUDA libraries under ``build/``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# import this folder as the package `benchmark`, never its modules as top-level names
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() not in (HERE, ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "surfh_tpu")
# settings the program reads from the environment that change what a model computes
PROGRAM_SETTINGS = ("SURFH_PSF_STAMPS", "SURFH_COMPOSED_GRIDDING", "SURFH_SIM_PSF", "SURFH_CONV_FREQ_RTOL",
                    "SURFH_CONV_PRECISION", "SURFH_CONV_RANK_RTOL", "SURFH_POINTING_SCAN")


def log(msg: str) -> None:
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def hygiene(root: Path) -> None:
    """Fixed cache directories in the checkout; no stray program settings."""
    cache = root / ".bench_cache"
    os.environ["SURFH_TABLE_CACHE"] = str(cache / "tables")
    os.environ["SURFH_CACHE_DIR"] = str(cache / "wpsf")
    for k in PROGRAM_SETTINGS:
        os.environ.pop(k, None)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0].strip() if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def end_to_end(name: str, run: dict) -> float:
    if name == "setup_s":
        return run["setup_s"]
    if name == "peak_gib":
        return run["peak_bytes"] / 2**30
    if name == "cg_ms_per_iter":
        return run["window_s"] * 1e3 / run["units"]["iterations"]
    if name == "gvox_per_s":
        return run["units"]["normals"] * 2.0 * run["voxels"] / run["window_s"] / 1e9
    raise KeyError(f"no end-to-end metric {name!r}")


def run_cell(args, device, cell: dict, capture=None, clock=process_age_s) -> dict:
    """Set-up, window, trace and comparison of one run; the result object."""
    import torch

    from benchmark.bench import check, program, traffic as traffic_mod, trace as trace_mod, yardstick
    from benchmark.bench.spec import metric_reader

    config, traffic = cell["config"], cell["traffic"]
    stages = program.Stages(log)
    model = program.build(config, device, stages)
    x = program.seed_unknown(config, args.seed, device)
    kw = {"capture": capture} if capture is not None else {}
    work = traffic_mod.make(model, x, config, traffic, stages, args.seed, cell["bench_dir"], **kw)
    setup_s = clock()
    log(f"set-up {setup_s:.3f} s; window of {args.seconds} s ({traffic['kind']})")

    prof, n_traced = None, 0
    t0 = time.perf_counter()
    index = 0
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(trace_mod.WINDOW_SPAN):
                for _ in range(int(traffic["trace_units"])):
                    work.unit(index)
                    index += 1
        n_traced = dict(work.units())
    while time.perf_counter() - t0 < args.seconds:
        work.unit(index)
        index += 1
    window_s = time.perf_counter() - t0
    units = dict(work.units())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"window {window_s:.3f} s: {index} {work.unit_name}s, {units}")

    result_metrics, extra = {}, {}
    if args.trace:
        view = trace_mod.view_from_profile(prof, n_traced, lambda: yardstick.work_counts(config))
        del prof
        for m in cell["per_layer"]:
            v = metric_reader(m["name"], cell["bench_dir"])(view)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": view.busy_s, "window_s": view.window_s, "breakdown": view.breakdown()}
    else:
        from benchmark.reference.instrument import problem_inputs

        inp = problem_inputs(config["problem"])
        run = {"setup_s": setup_s, "peak_bytes": peak, "window_s": window_s, "units": units,
               "voxels": len(inp["wavel"]) * len(inp["alpha"]) * len(inp["beta"])}
        for m in cell["end_to_end"]:
            result_metrics[m["name"]] = {"value": end_to_end(m["name"], run), "unit": m["unit"]}

    answers = work.sample.answers()
    x_host = x.detach().to("cpu", copy=True)
    work.free()
    del work, model, x
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.reference_answer(config, traffic, x_host, device, cell["bench_dir"])
    numbers = check.compare(answers, ref, cell["limits"])
    log(f"reference: {time.perf_counter() - t_ref:.3f} s, {len(answers)} answers "
        f"(units {[i for i, _ in answers]})")
    return {"correct": check.passed(numbers), "attempted": index, "failed": 0,
            "metrics": result_metrics, "peak": peak, "extra": extra, "checks": numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.bench.spec import cell as load_cell

    cell = load_cell(args.workload)
    hygiene(ROOT)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s): torch.cuda.is_available() {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} device(s); no result")
        return 2
    device = torch.device("cuda", 0)
    card = power_limit()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"workload {args.workload}, seed {args.seed}, {args.seconds} s, trace {args.trace}")
    res = run_cell(args, device, cell)
    bad = loaded_forbidden()
    if bad:
        log(f"modules loaded that the benchmark must not load: {', '.join(bad)}; no result")
        return 3
    out = {
        "correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
        "metrics": res["metrics"],
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                   "memory_peak_bytes": int(res["peak"]), "power_limit": card,
                   **{k: v for k, v in res["extra"].items() if k in ("busy_s", "window_s")}},
    }
    if "breakdown" in res["extra"]:
        out["breakdown"] = res["extra"]["breakdown"]
    out["checks"] = res["checks"]
    for name, n in res["checks"].items():
        print(f"check {name}: {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
