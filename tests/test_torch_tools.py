"""The port's user tools on the CPU against the unmodified JAX scripts, each
run as a subprocess: `scripts/torch_run_fusion_simulated.py`,
`torch_learn_templates.py`, `torch_correct_mrs_data.py`,
`torch_filter_slices.py` and `torch_convert_s3d.py`.

Tolerances, measured here and why:

* `run_fusion_simulated --quick --niter 5` (the exact W-plane model,
  float32): the gradient-norm histories agree to 6.4e-6 (from 0.5) and
  4.9e-5 (sharded, from zero maps), bound 1e-4; `relative_error_pct` to
  1e-6 (the JAX script rounds it to 4 decimals), bound 1e-4.  Past 5
  iterations float32 CG amplifies the two FFT and GEMM libraries' rounding
  with each iteration on this problem (3e-3 at 6 sharded, ~1 by 10; the
  final error of 15 iterations then moves with the thread count), so the
  comparison stops there.
* `learn_templates --demo`: PCA's components (up to each one's sign) 3e-6
  and its variances, bound 1e-5; N-FINDR's endmembers and indices exactly;
  FCLS's abundances after 200 float32 projected-gradient steps 2.7e-5,
  bound 1e-4; NMF from the same initial factors (`--seed 0`, the JAX
  script's draw) after 500 float32 multiplicative updates: templates and
  abundances 3.5e-6, bound 1e-5, its error 3.2e-4, bound 1e-3.
* `correct_mrs_data` (the Shepard regrid in float32): 6.7e-8, bound 1e-6;
  `filter_slices` and `convert_s3d` (host NumPy and SciPy in both):
  exactly, headers too.

The stage-2 fixture is `simulation.stage2`'s synthetic frame (band 4a,
48 detector rows), as `cli rehearse` writes it; the JAX script reads its
WCS through a stand-in for the `jwst` package (not in this image) that
serves the frame's own ALPHA / BETA / LAM maps.  The s3d fixture is
`tests/test_s3d.py`'s."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]

JWST_STUB = '''from types import SimpleNamespace

from surfh_tpu.simulation.stage2 import stage2_wcs_loader


def open(path):
    data, d2w = stage2_wcs_loader(path)
    wcs = SimpleNamespace(get_transform=lambda a, b: d2w)
    return SimpleNamespace(data=data, meta=SimpleNamespace(wcs=wcs))
'''


def _env(tmp_path, pythonpath=None):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(SURFH_TABLE_CACHE="0", SURFH_CACHE_DIR=str(tmp_path / "cache"), TMPDIR=str(tmp_path),
               HOME=str(tmp_path), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    if pythonpath:
        env["PYTHONPATH"] = str(pythonpath)
    return env


def _run(tmp_path, script, *args, pythonpath=None):
    proc = subprocess.run([sys.executable, f"scripts/{script}", *args], cwd=ROOT,
                          env=_env(tmp_path, pythonpath), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (script, proc.stderr[-3000:])
    return proc.stdout


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _rel_max(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("sharded", [False, True])
def test_run_fusion_simulated_matches_the_jax_script(tmp_path, sharded):
    """`--quick`, unsharded (the criterion from 0.5) and sharded (a world of
    1, from zero maps) as the JAX script's."""
    args = ["--quick", "--niter", "5", "--cpu"] + (["--sharded"] if sharded else [])
    want = _json_lines(_run(tmp_path, "run_fusion_simulated.py", *args,
                            "--output-dir", str(tmp_path / "j")))[-1]
    got = _json_lines(_run(tmp_path, "torch_run_fusion_simulated.py", *args,
                           "--output-dir", str(tmp_path / "p")))[-1]
    assert set(want) <= set(got) and got["device"] == "cpu"
    assert got["niter"] == want["niter"] == 5
    assert abs(got["relative_error_pct"] - want["relative_error_pct"]) <= 1e-4 * want["relative_error_pct"]
    crit_j, crit_p = np.load(tmp_path / "j" / "criterion.npy"), np.load(tmp_path / "p" / "criterion.npy")
    assert crit_p.shape == crit_j.shape == (6,)
    assert (np.abs(crit_p - crit_j) <= 1e-4 * crit_j).all()
    for name in ("res_x.npy", "res_cube.npy"):
        assert np.load(tmp_path / "p" / name).shape == np.load(tmp_path / "j" / name).shape


@pytest.mark.parametrize("method", ["pca", "nfindr", "nmf"])
def test_learn_templates_demo_matches_the_jax_script(tmp_path, method):
    want = _json_lines(_run(tmp_path, "learn_templates.py", "--demo", "--method", method, "--cpu",
                            "-o", str(tmp_path / "j")))[-1]
    got = _json_lines(_run(tmp_path, "torch_learn_templates.py", "--demo", "--method", method,
                           "--cpu", "-o", str(tmp_path / "p")))[-1]
    assert set(want) <= set(got) and got["method"] == method

    def load(side, name):
        return np.load(tmp_path / side / name)

    np.testing.assert_array_equal(load("p", "wavel_axis.npy"), load("j", "wavel_axis.npy"))
    tp, tj = load("p", "templates.npy"), load("j", "templates.npy")
    assert tp.shape == tj.shape == (4, 300)
    if method == "pca":
        tp = tp * np.sign((tp * tj).sum(axis=1, keepdims=True))  # each component's sign is its SVD's
        assert _rel_max(tp, tj) <= 1e-5
        np.testing.assert_allclose(got["explained_variance"], want["explained_variance"], rtol=1e-5)
    elif method == "nfindr":
        assert got["endmember_indices"] == want["endmember_indices"]
        np.testing.assert_array_equal(tp, tj)
        assert _rel_max(load("p", "abundances_flat.npy"), load("j", "abundances_flat.npy")) <= 1e-4
    else:
        assert _rel_max(tp, tj) <= 1e-5
        assert _rel_max(load("p", "abundances.npy"), load("j", "abundances.npy")) <= 1e-5
        assert abs(got["error"] - want["error"]) <= 1e-3 * want["error"]


def _stage2_frames(tmp_path):
    """Two synthetic band-4a stage-2 frames (48 detector rows), one per
    dither pointing, and a global λ axis around the band."""
    from surfh_tpu_torch.instrument.wavelength_mrs import get_mrs_wavelength
    from surfh_tpu_torch.simulation.stage2 import write_synthetic_stage2

    raw = tmp_path / "raw"
    raw.mkdir()
    for p in range(2):
        write_synthetic_stage2(str(raw / f"obs1_ch4a_dither{p + 1}_cal.fits"), "4a",
                               83.83 + 1e-4 * p, -5.42, n_rows=48, strip_w=5,
                               scene_ra=83.83, scene_dec=-5.42, seed=p)
    lam = get_mrs_wavelength("4a")
    np.save(tmp_path / "wl.npy", np.linspace(lam[0] - 0.5, lam[-1] + 0.5, 80))
    return raw


def test_correct_and_filter_match_the_jax_scripts(tmp_path):
    from surfh_tpu_torch.preprocessing.fits_io import fits_open

    raw = _stage2_frames(tmp_path)
    stub = tmp_path / "stub" / "jwst"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    (stub / "datamodels.py").write_text(JWST_STUB)
    common = ["--raw-dir", str(raw), "--npix", "61", "--wavel-cube", str(tmp_path / "wl.npy")]
    _run(tmp_path, "correct_mrs_data.py", *common, "--out-dir", str(tmp_path / "cj"),
         pythonpath=stub.parent)
    _run(tmp_path, "torch_correct_mrs_data.py", *common, "--out-dir", str(tmp_path / "cp"),
         "--cpu")
    names = sorted(os.listdir(tmp_path / "cj"))
    assert names == sorted(os.listdir(tmp_path / "cp")) and len(names) == 2
    for name in names:
        hj, hp = fits_open(str(tmp_path / "cj" / name))[0], fits_open(str(tmp_path / "cp" / name))[0]
        for k in ("PA_V3", "TARG_RA", "TARG_DEC", "BAND"):
            assert hp.header[k] == hj.header[k], k
        dj, dp = np.asarray(hj.data), np.asarray(hp.data)
        assert dp.shape == dj.shape and (dj != 0).any()
        assert _rel_max(dp, dj) <= 1e-6

    # the filter on one set of corrected slices: host NumPy in both, so exactly
    _run(tmp_path, "filter_slices.py", "--in-dir", str(tmp_path / "cj"), "--out-dir",
         str(tmp_path / "fj"), "--size", "5")
    _run(tmp_path, "torch_filter_slices.py", "--in-dir", str(tmp_path / "cj"), "--out-dir",
         str(tmp_path / "fp"), "--size", "5")
    names = sorted(os.listdir(tmp_path / "fj"))
    assert names == sorted(os.listdir(tmp_path / "fp")) and len(names) == 2
    for name in names:
        hj, hp = fits_open(str(tmp_path / "fj" / name))[0], fits_open(str(tmp_path / "fp" / name))[0]
        np.testing.assert_array_equal(np.asarray(hp.data), np.asarray(hj.data))
        assert {k: hp.header[k] for k in ("PA_V3", "TARG_RA", "TARG_DEC", "BAND")} == {
            k: hj.header[k] for k in ("PA_V3", "TARG_RA", "TARG_DEC", "BAND")}


def test_filter_slices_without_a_match_fails(tmp_path):
    (tmp_path / "in").mkdir()
    proc = subprocess.run([sys.executable, "scripts/torch_filter_slices.py", "--in-dir",
                           str(tmp_path / "in"), "--out-dir", str(tmp_path / "out")], cwd=ROOT,
                          env=_env(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and "no matching .fits files" in proc.stderr


def test_convert_s3d_matches_the_jax_script(tmp_path):
    from test_s3d import _write_s3d

    cube = np.random.default_rng(0).random((4, 12, 12))
    _write_s3d(tmp_path / "ChannelCube_test_s3d.fits", cube, cd=0.13 / 3600.0)
    args = ["--s3d", str(tmp_path / "ChannelCube_test_s3d.fits"), "--npix", "9", "--step", "0.05",
            "--oversample", "2", "--border", "2"]
    want = _json_lines(_run(tmp_path, "convert_s3d.py", *args, "--out-dir", str(tmp_path / "j")))
    got = _json_lines(_run(tmp_path, "torch_convert_s3d.py", *args, "--out-dir", str(tmp_path / "p")))
    assert got == want and got[0]["cube_shape"] == [4, 9, 9]
    for suffix in ("", "_mask", "_wavel"):
        name = f"ChannelCube_test_s3d{suffix}.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "p" / name), np.load(tmp_path / "j" / name))


def test_correct_reads_a_file_s_own_wcs_maps_else_the_jwst_datamodel(tmp_path):
    """`torch_correct_mrs_data.py` picks the WCS source from the file: the
    synthetic stage-2 frames' ALPHA / BETA / LAM maps, else (None)
    `correct_file`'s jwst datamodel."""
    import importlib.util

    from surfh_tpu_torch.preprocessing.fits_io import fits_write
    from surfh_tpu_torch.simulation.stage2 import stage2_wcs_loader

    spec = importlib.util.spec_from_file_location("torch_correct_mrs_data",
                                                  ROOT / "scripts" / "torch_correct_mrs_data.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    raw = _stage2_frames(tmp_path)
    frames = sorted(raw.glob("*.fits"))
    assert frames and all(script._wcs_loader(str(f)) is stage2_wcs_loader for f in frames)
    plain = tmp_path / "plain_cal.fits"
    fits_write(str(plain), np.zeros((4, 4), np.float32), header={"PA_V3": 0.0})
    assert script._wcs_loader(str(plain)) is None


@pytest.mark.parametrize("script", ["torch_run_fusion_simulated.py", "torch_learn_templates.py",
                                    "torch_correct_mrs_data.py"])
def test_tools_need_the_card_unless_asked(tmp_path, script):
    args = {"torch_run_fusion_simulated.py": ["--quick"],
            "torch_learn_templates.py": ["--demo", "--method", "pca"],
            "torch_correct_mrs_data.py": ["--raw-dir", str(tmp_path), "--out-dir", str(tmp_path / "o")]}
    env = _env(tmp_path)
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, f"scripts/{script}", *args[script]], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
