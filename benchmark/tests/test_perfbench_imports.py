"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program (top-level module names compared
whole: `surfh_tpu_torch` is not `surfh_tpu`)."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "surfh_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not {n for n in top_level_imports(path) if n.startswith("surfh")}, path


def test_forbidden_names_compare_whole():
    saved = {k: sys.modules.get(k) for k in ("surfh_tpu", "surfh_tpu_torch")}
    try:
        sys.modules.pop("surfh_tpu", None)
        sys.modules.setdefault("surfh_tpu_torch", type(sys)("surfh_tpu_torch"))
        assert "surfh_tpu" not in run.loaded_forbidden()
        sys.modules["surfh_tpu.models"] = type(sys)("surfh_tpu.models")
        assert run.loaded_forbidden() == ["surfh_tpu"]
    finally:
        sys.modules.pop("surfh_tpu.models", None)
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_importing_the_harness_and_the_program_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.control, benchmark.bench.check, benchmark.bench.program\n"
            "import benchmark.bench.traffic, benchmark.bench.trace\n"
            "import surfh_tpu_torch.simulation.flagship, surfh_tpu_torch.solvers.criterion\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules} & %r))" % (str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
