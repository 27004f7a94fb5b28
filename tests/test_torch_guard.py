"""Guards of the port: no JAX and nothing of `surfh_tpu` on its import
path (nor click), `chip_smoke.py` refuses to report anything without a card
or without the repository, the setup functions, the real-data pipeline's
model, the all-band pipeline, the decompositions, the Shepard regrid and
the diffraction PSF (`psf_stack_device`, `gen-psf`), the blind-2D models
and `deconv2d` / `deconv-cube` pick the card unless asked for the CPU,
the operator family, the mixing models and `scripts/torch_operator_demo.py`
pick the card unless asked for the CPU, `run_method` accepts the
reference's `perf_crit` and reads it not, and the sharded paths take NCCL
on the card and raise without one unless SURFH_CPU asks for gloo on the
CPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "surfh_tpu_torch",
    "surfh_tpu_torch.core",
    "surfh_tpu_torch.utils",
    "surfh_tpu_torch.parallel",
    "surfh_tpu_torch.parallel.fusion",
    "surfh_tpu_torch.parallel.lambda_sharded",
    "surfh_tpu_torch.parallel.mesh2d",
    "surfh_tpu_torch.preprocessing.s3d",
    "surfh_tpu_torch.simulation.data",
    "surfh_tpu_torch.viz",
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
    "surfh_tpu_torch.core.linop",
    "surfh_tpu_torch.core.nearest",
    "surfh_tpu_torch.models.blind2d",
    "surfh_tpu_torch.models",
    "surfh_tpu_torch.models.family",
    "surfh_tpu_torch.models.mixing",
    "surfh_tpu_torch.core.blockfourier",
    "surfh_tpu_torch.solvers",
    "surfh_tpu_torch.solvers.expsol",
    "surfh_tpu_torch.solvers.huber",
    "surfh_tpu_torch.simulation",
    "surfh_tpu_torch.instrument",
    "surfh_tpu_torch.instrument.geometry",
    "surfh_tpu_torch.instrument.ifu",
    "surfh_tpu_torch.instrument.spectral",
    "surfh_tpu_torch.instrument.miri",
    "surfh_tpu_torch.instrument.wavelength_mrs",
    "surfh_tpu_torch.utils.psf",
    "surfh_tpu_torch.utils.jwst_psf",
    "surfh_tpu_torch.utils.profiling",
    "surfh_tpu_torch.models.slicer",
    "surfh_tpu_torch.models.channel",
    "surfh_tpu_torch.models.spectro",
    "surfh_tpu_torch.simulation.synthetic",
    "surfh_tpu_torch.simulation.flagship",
    "surfh_tpu_torch.solvers.cg",
    "surfh_tpu_torch.solvers.criterion",
    "surfh_tpu_torch.solvers.checkpoint",
    "surfh_tpu_torch.preprocessing",
    "surfh_tpu_torch.preprocessing.fits_io",
    "surfh_tpu_torch.preprocessing.metadata",
    "surfh_tpu_torch.preprocessing.shepard",
    "surfh_tpu_torch.preprocessing.distortion",
    "surfh_tpu_torch.preprocessing.correction_driver",
    "surfh_tpu_torch.instrument.realmiri",
    "surfh_tpu_torch.instrument.smallmiri",
    "surfh_tpu_torch.simulation.stage2",
    "surfh_tpu_torch.core.numpy_ref",
    "surfh_tpu_torch.utils.metrics",
    "surfh_tpu_torch.pipeline",
    "surfh_tpu_torch.cli",
    "surfh_tpu_torch.utils.rehearsal_sweep",
    "surfh_tpu_torch.learning",
    "surfh_tpu_torch.learning.decomposition",
    "surfh_tpu_torch.config",
    "chip_smoke",
    "torch_scatter_proto",  # scripts/
    "torch_profile",  # scripts/
    "torch_operator_demo",  # scripts/
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
        "assert 'click' not in sys.modules, 'click imported'\n"
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


def test_pipeline_and_shepard_go_to_the_card_by_default(monkeypatch):
    """`pipeline.create_model(...)` and the Shepard regrid with no `device`
    run on the card: without one they raise, and never fall back to the CPU."""
    import numpy as np
    import torch

    from surfh_tpu_torch import pipeline
    from surfh_tpu_torch.preprocessing.shepard import exponential_modified_shepard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    band, npix, step = "4a", 31, 0.1 / 3600
    dd = {"data": {band: []}, "target": {band: [(83.83, -5.41)]}, "rotation": {band: 0.0}}
    inst = pipeline.create_instruments(dd, [band])
    wl = pipeline.get_mrs_wavelength(band)[::20]
    a = (np.arange(npix) - npix // 2) * step
    args = (np.ones((len(wl), npix, npix // 2 + 1), np.complex64), np.ones((2, len(wl))), a, a.copy(),
            wl, inst, step, dd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.create_model(*args)
    m = pipeline.create_model(*args, device="cpu")
    assert m.device.type == "cpu" and m.tables is not None
    pts = np.zeros(3), np.zeros(3), np.ones(3), np.zeros((2, 2)), np.zeros((2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exponential_modified_shepard(*pts)
    assert exponential_modified_shepard(*pts, device="cpu").shape == (2, 2)


def test_allband_and_decompositions_go_to_the_card_by_default(monkeypatch):
    """`run_allband_simulated` and the decompositions given host arrays
    with no `device` run on the card: without one they raise, and never
    fall back to the CPU."""
    import numpy as np
    import torch

    from surfh_tpu_torch import pipeline
    from surfh_tpu_torch.learning import decomposition

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_allband_simulated(npix=31, bands=["1a"], n_pointings=1, n_templates=2,
                                       niter=1, nmf_iter=1)
    X = np.random.default_rng(0).random((20, 6))
    for call in (lambda: decomposition.nmf(X, 2, n_iter=1), lambda: decomposition.pca(X, 2),
                 lambda: decomposition.nfindr(X, 3), lambda: decomposition.fcls(X, X[:2]),
                 lambda: decomposition.learn_templates_nmf(X.T.reshape(6, 4, 5), 2, n_iter=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    W, H, _ = decomposition.nmf(torch.as_tensor(X), 2, n_iter=1)  # a tensor keeps its device
    assert W.device.type == "cpu"


def test_psf_generation_goes_to_the_card_by_default(monkeypatch, tmp_path):
    """`psf_stack_device` with no `device` and `gen-psf` without SURFH_CPU
    run on the card: without one they raise, and never fall back to the CPU."""
    import numpy as np
    import torch

    from surfh_tpu_torch import cli
    from surfh_tpu_torch.utils import jwst_psf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SURFH_CPU", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jwst_psf.psf_stack_device(np.array([8.0]), 0.05, npix=11, n_pupil=32)
    np.save(tmp_path / "lam.npy", np.array([8.0]))
    out = tmp_path / "psf.npy"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["gen-psf", "-w", str(tmp_path / "lam.npy"), "--npix", "11", "-o", str(out)])
    assert not out.exists()
    got = jwst_psf.psf_stack_device(np.array([8.0]), 0.05, npix=11, n_pupil=32, device="cpu")
    assert got.shape == (1, 11, 11) and got.dtype == np.float32


@pytest.mark.parametrize("method", ["lcg", "mmmg"])
def test_run_method_accepts_and_ignores_perf_crit(method):
    """The reference takes `perf_crit` and never reads it; so does the port:
    the same run with and without one gives the same bits, and it is never
    called."""
    import numpy as np
    import torch

    from surfh_tpu_torch.simulation.synthetic import make_model
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

    model, setup = make_model(im_size=21, n_lambda=12, n_tpl=2, n_channels=1, n_pointings=1,
                              n_slit=3, dtype=np.float64, window_local=False)
    model.to("cpu", torch.float64)
    y = model.forward(torch.as_tensor(setup["maps"]))
    crit = QuadCriterion_MRS(1.0, y, model, 10.0)
    calls = []
    a = crit.run_method(method, 5, 1e-12, False, lambda x: calls.append(x))
    b = crit.run_method(method, 5, perf_crit=object())
    c = crit.run_method(method, 5)
    assert calls == []
    assert torch.equal(a.x, c.x) and torch.equal(b.x, c.x)
    np.testing.assert_array_equal(a.grad_norm, c.grad_norm)


@pytest.mark.parametrize("name", ["deconv2d", "deconv-cube"])
def test_deconvolution_goes_to_the_card_by_default(monkeypatch, tmp_path, name):
    """The blind-2D models with no `device` and `deconv2d` / `deconv-cube`
    without SURFH_CPU run on the card: without one they raise, write
    nothing, and never fall back to the CPU."""
    import numpy as np
    import torch

    from surfh_tpu_torch import cli
    from surfh_tpu_torch.core.fft import ir2fr
    from surfh_tpu_torch.models.blind2d import MRSBlurred, MRSBlurredRectangle
    from surfh_tpu_torch.simulation.synthetic import make_setup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SURFH_CPU", raising=False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([name, "-np", "41", "-ni", "2", "-o", str(out)])
    assert not out.exists()
    s = make_setup(im_size=41, n_lambda=8, n_channels=1, n_pointings=2)
    args = (ir2fr(s["spsf"][0], s["im_shape"]), s["alpha_axis"], s["beta_axis"], s["instrs"][0],
            s["step_degree"], s["pointings"][0])
    cls = MRSBlurredRectangle if name == "deconv-cube" else MRSBlurred
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(*args)
    assert cls(*args, device="cpu").device.type == "cpu"
    assert np.isfinite(cls(*args, device="cpu").forward(np.ones(s["im_shape"])).numpy()).all()


def test_family_mixing_and_operator_demo_go_to_the_card_by_default(monkeypatch, capsys):
    """The family and mixing operators with no `device`, the criterion's
    joint prior, and `torch_operator_demo.py` without --cpu run on the
    card: without one they raise, and never fall back to the CPU."""
    import importlib.util

    import numpy as np
    import torch

    from surfh_tpu_torch.models import family, mixing
    from surfh_tpu_torch.simulation.synthetic import make_setup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = make_setup(im_size=21, n_lambda=8, n_tpl=2, n_channels=1, n_pointings=1, n_slit=3)
    a = (s["sotf"], s["templates"], s["alpha_axis"], s["beta_axis"], s["wavelength_axis"],
         s["instrs"][0], s["step_degree"])
    psfs = np.ones((8, 3, 3)) / 9
    for make in (lambda **kw: family.SpectroSigRLCT(*a, **kw),
                 lambda **kw: family.MO_SigRLSCT(*a, s["pointings"][0], **kw),
                 lambda **kw: mixing.Model_WCT(psfs, s["templates"], (21, 21), **kw),
                 lambda **kw: mixing.MixingST(s["templates"], s["alpha_axis"], s["beta_axis"],
                                              s["wavelength_axis"], **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").device.type == "cpu"
    spec = importlib.util.spec_from_file_location("torch_operator_demo",
                                                  ROOT / "scripts" / "torch_operator_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--op", "SigRLT", "--npix", "21", "--n-lambda", "8", "--channels", "1"])
    assert demo.main(["--op", "SigRLT", "--npix", "21", "--n-lambda", "8", "--channels", "1",
                      "--cpu", "--solve"]) == 0
    assert '"dottest": true' in capsys.readouterr().out


def test_sharding_on_the_card_takes_nccl(monkeypatch):
    """`make_mesh()` (what `ShardedSpectro` and `fusion --sharded` run on)
    with a card and no process group: the card of LOCAL_RANK, then an NCCL
    world of 1, then a "cuda" mesh — never gloo, never the CPU."""
    import torch
    import torch.distributed as dist
    import torch.distributed.device_mesh as dm

    from surfh_tpu_torch.parallel import fusion

    calls = {}
    monkeypatch.delenv("SURFH_CPU", raising=False)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.setdefault("device", d))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.setdefault("backend", (backend, kw["world_size"])))
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 1)
    monkeypatch.setattr(dm, "init_device_mesh",
                        lambda t, shape, mesh_dim_names: calls.setdefault("mesh", (t, shape)))
    fusion.make_mesh()
    assert calls == {"device": 0, "backend": ("nccl", 1), "mesh": ("cuda", (1,))}


def test_fusion_sharded_needs_a_card_or_the_switch(monkeypatch, tmp_path):
    """`fusion --sharded` and `make_mesh()` without a card raise; under
    SURFH_CPU the mesh is a gloo world on the CPU."""
    import torch
    import torch.distributed as dist

    from surfh_tpu_torch import cli
    from surfh_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SURFH_CPU", raising=False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["fusion", "--simulated", "--sharded", "-np", "31", "-o", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert not out.exists() and not dist.is_initialized()
    monkeypatch.setenv("SURFH_CPU", "1")
    mesh = make_mesh()
    try:
        assert mesh.device_type == "cpu" and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
