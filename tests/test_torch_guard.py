"""Guards of the port: no JAX and nothing of `surfh_tpu` on its import
path, `chip_smoke.py` refuses to report anything without a card or without
the repository, and the setup functions pick the card unless asked for the CPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

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
    "surfh_tpu_torch.core.gather_fixed",
    "surfh_tpu_torch.instrument",
    "surfh_tpu_torch.instrument.geometry",
    "surfh_tpu_torch.instrument.ifu",
    "surfh_tpu_torch.instrument.spectral",
    "surfh_tpu_torch.instrument.miri",
    "surfh_tpu_torch.instrument.wavelength_mrs",
    "surfh_tpu_torch.utils.psf",
    "surfh_tpu_torch.utils.profiling",
    "surfh_tpu_torch.models.slicer",
    "surfh_tpu_torch.models.channel",
    "surfh_tpu_torch.models.spectro",
    "surfh_tpu_torch.simulation.synthetic",
    "surfh_tpu_torch.simulation.flagship",
    "surfh_tpu_torch.solvers.cg",
    "surfh_tpu_torch.solvers.criterion",
    "chip_smoke",
    "torch_scatter_proto",  # scripts/
    "torch_profile",  # scripts/
]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even where there is one
    return env


def test_slice_imports_no_jax():
    code = (
        "import importlib, sys\n"
        "sys.path.append('scripts')\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules if m == 'surfh_tpu' or m.startswith('surfh_tpu.')]\n"
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


def test_flagship_otf_goes_to_the_card_by_default(monkeypatch):
    """`make_flagship_setup(build_sotf=True)` with no `device` builds the
    OTF on the card: without one it raises, and never falls back to the CPU."""
    import torch

    from surfh_tpu_torch.simulation import flagship

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(npix=31, bands=["1a"], n_pointings=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship.make_flagship_setup(build_sotf=True, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship.make_flagship_model(window_local=False, **kw)
    s = flagship.make_flagship_setup(build_sotf=True, device="cpu", **kw)
    assert s["sotf"].device.type == "cpu" and s["sotf"].shape == (len(s["wavelength_axis"]), 31, 16)
    assert flagship.make_flagship_setup(**kw)["sotf"] is None  # no OTF, no device
