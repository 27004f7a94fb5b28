"""Guards of the port: no JAX on its import path, and `chip_smoke.py`
refuses to report anything without a card or without the repository."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "surfh_tpu_torch",
    "surfh_tpu_torch.convert",
    "surfh_tpu_torch.core.precision",
    "surfh_tpu_torch.core.fft",
    "surfh_tpu_torch.core.bilinear",
    "surfh_tpu_torch.core.gather_rows",
    "surfh_tpu_torch.core._build",
    "surfh_tpu_torch.core.wblur",
    "surfh_tpu_torch.core.wblur_banded",
    "surfh_tpu_torch.core.lmm",
    "surfh_tpu_torch.utils.psf",
    "surfh_tpu_torch.models.slicer",
    "surfh_tpu_torch.models.channel",
    "surfh_tpu_torch.models.spectro",
    "surfh_tpu_torch.simulation.synthetic",
    "surfh_tpu_torch.simulation.flagship",
    "surfh_tpu_torch.solvers.cg",
    "surfh_tpu_torch.solvers.criterion",
    "chip_smoke",
]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even where there is one
    return env


def test_slice_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules if m.startswith('surfh_tpu.')"
        " and not m.startswith('surfh_tpu.instrument')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
