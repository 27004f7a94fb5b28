"""surfh_tpu_torch's command line (`python -m surfh_tpu_torch.cli`) against
the JAX package's (`surfh_tpu.cli`), with ``SURFH_CPU=1`` (CPU, float32 as
the commands run).

* `rehearse` on the sizes of tests/test_rehearse.py's header-seeded run
  (band from the vendored cal header, np 61, step 0.17″, λ-subsample 12,
  25 iterations): the same report keys, the numbers within 1e-3 absolute
  (the timings and the output directory aside), and both reports meet the
  reference's bars (tests/test_rehearse.py:48-56);
* `fusion --simulated` at a small size, 4 iterations (f32 CG amplifies
  rounding: 2e-6, 8e-6, 1e-4 of the max after 2, 4, 8): the same
  iterations, x within 1e-4 of its max, PSNR within 1e-2 dB;
* `make-cube` (.npy and FITS), `compare-flux` and `info`; the rehearsal
  sweep (`python -m surfh_tpu_torch.utils.rehearsal_sweep`) at a small size;
* `--method mmmg` on `fusion --simulated` and `rehearse`, against the JAX
  commands (`allband`: tests/test_torch_allband.py);
* `gen-psf` (the band's λ table or a given axis, with and without
  ``--opd commissioning``, a Zernike .npy OPD) against the JAX command at
  a small size: the same report keys and values, the stacks ≤1e-5 of the
  peak (the reference's jax f32 products, the port's NumPy ones);
* `deconv2d` and `deconv-cube`, rectangle and rotated, at the JAX CLI
  tests' sizes: the same report keys and iterations, the psnr within
  1e-2 dB of the JAX command's;
* `fusion --simulated --sharded` at world 1 in-process against the JAX
  command's sharded run (8 virtual devices): the same report keys and
  iterations, x within 1e-4 of its max; checkpointed in segments, bit for
  bit the uninterrupted run; at world 2 under ``torchrun`` (rank 0 alone
  reports and writes) against world 1 within 1e-4;
* `metadata` (all four operations) on FITS files the test writes, against
  the JAX command on a copy of them: the same JSON and the same headers and
  data afterwards; its usage errors exit with the same code;
* `warmup` on a toy band list: its JSON, no kernel built on the CPU, a
  cold table build then a cache hit;
* without a card and without ``SURFH_CPU`` the commands raise.
"""

import contextlib
import functools
import io
import json
import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from surfh_tpu.cli import cli as jax_cli
from surfh_tpu_torch import cli

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "miri_mrs_cal_header.txt")
REHEARSE = ["--header", FIXTURE, "--pointings", "2", "-np", "61", "--step", "0.17",
            "--lambda-subsample", "12", "-hp", "1.0", "-ni", "25"]
NOT_COMPARED = ("t_stage2_s", "t_correct_s", "t_fusion_s", "output_dir")
TOL_REPORT = 1e-3  # f32 solves in both packages; measured ~2e-7


def port(argv):
    """Run the port's CLI in-process; returns the JSON of its last line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def ref(argv):
    r = CliRunner().invoke(jax_cli, argv)
    assert r.exit_code == 0, r.output
    return json.loads(r.output.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("SURFH_CPU", "1")


@pytest.fixture(scope="module")
def rehearsals(tmp_path_factory):
    work = tmp_path_factory.mktemp("rehearse")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SURFH_CPU", "1")
        got = port(["rehearse", "-w", str(work / "port")] + REHEARSE)
        want = ref(["rehearse", "-w", str(work / "jax")] + REHEARSE)
    return work, got, want


def test_rehearse_report_keys(rehearsals):
    _, got, want = rehearsals
    assert list(got) == list(want)
    assert got["band"] == "1a" and got["pa_v3"] == pytest.approx(68.57554349924975)


def test_rehearse_numbers_agree(rehearsals):
    _, got, want = rehearsals
    for k in want:
        if k in NOT_COMPARED:
            continue
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            assert abs(got[k] - want[k]) <= TOL_REPORT, (k, got[k], want[k])


@pytest.mark.parametrize("side", ["port", "jax"])
def test_rehearse_meets_the_reference_bars(rehearsals, side):
    _, got, want = rehearsals
    rep = got if side == "port" else want
    assert rep["residual_rel"] < 0.10, rep
    assert 0.9 < rep["flux_ratio_median"] < 1.1, rep
    assert rep["flux_shape_corr"] > 0.9, rep
    assert rep["flux_points"] > 50


def test_rehearse_outputs(rehearsals):
    work, got, _ = rehearsals
    root = work / "port"
    assert len([f for f in os.listdir(root / "raw") if f.endswith(".fits")]) == 2
    assert len([f for f in os.listdir(root / "Filtered_slices") if f.endswith(".fits")]) == 2
    for f in ("res_x.npy", "res_cube.npy", "criterion.npy", "flux_compare.npz", "solver_state.npz"):
        assert os.path.exists(root / "out" / f), f
    assert got["output_dir"] == str(root / "out")
    jx, px = np.load(work / "jax" / "out" / "res_x.npy"), np.load(root / "out" / "res_x.npy")
    assert np.abs(px - jx).max() <= TOL_REPORT * np.abs(jx).max()


def test_fusion_simulated(tmp_path):
    argv = ["fusion", "--simulated", "-np", "31", "--n-lambda", "16", "-nc", "1", "-nt", "3",
            "-ni", "4", "-hp", "10"]
    got = port(argv + ["-o", str(tmp_path / "port")])
    want = ref(argv + ["-o", str(tmp_path / "jax")])
    assert set(got) == set(want) and got["niter"] == want["niter"] == 4
    assert abs(got["psnr_maps"] - want["psnr_maps"]) <= 1e-2
    px, jx = np.load(tmp_path / "port" / "res_x.npy"), np.load(tmp_path / "jax" / "res_x.npy")
    assert px.shape == jx.shape and np.abs(px - jx).max() <= 1e-4 * np.abs(jx).max()
    for f in ("res_cube.npy", "criterion.npy", "solver_state.npz"):
        assert os.path.exists(tmp_path / "port" / f)


@pytest.mark.parametrize("ext", [".npy", ".fits"])
def test_make_cube(tmp_path, ext):
    from surfh_tpu_torch.preprocessing import fits_open

    rng = np.random.default_rng(5)
    np.save(tmp_path / "maps.npy", rng.random((3, 7, 6)))
    np.save(tmp_path / "tpl.npy", rng.random((3, 9)))
    np.save(tmp_path / "wavel.npy", np.linspace(5.0, 6.0, 9))
    argv = ["make-cube", "--maps", str(tmp_path / "maps.npy"), "--templates", str(tmp_path / "tpl.npy"),
            "--wavel-axis", str(tmp_path / "wavel.npy")]
    got = port(argv + ["-o", str(tmp_path / f"port{ext}")])
    want = ref(argv + ["-o", str(tmp_path / f"jax{ext}")])
    assert got["cube_shape"] == want["cube_shape"] == [9, 7, 6]
    if ext == ".npy":
        np.testing.assert_allclose(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"), rtol=1e-12)
    else:
        (a,), (b,) = fits_open(str(tmp_path / "port.fits")), fits_open(str(tmp_path / "jax.fits"))
        assert a.header == b.header
        np.testing.assert_allclose(a.data, b.data, rtol=1e-6)


def test_make_cube_rejects_mismatched_components(tmp_path):
    np.save(tmp_path / "maps.npy", np.ones((3, 4, 4)))
    np.save(tmp_path / "tpl.npy", np.ones((2, 5)))
    with pytest.raises(SystemExit) as e:
        cli.main(["make-cube", "--maps", str(tmp_path / "maps.npy"), "--templates",
                  str(tmp_path / "tpl.npy"), "-o", str(tmp_path / "c.npy")])
    assert e.value.code == 2


def test_compare_flux(tmp_path):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "fused.npy", rng.random((6, 8, 8)))
    np.save(tmp_path / "real.npy", rng.random((6, 8, 8)))
    argv = ["compare-flux", "--fusion-cube", str(tmp_path / "fused.npy"), "--real-cube",
            str(tmp_path / "real.npy"), "--median-size", "3", "--region", "2,2;2,6;6,6;6,2"]
    got = port(argv + ["--output", str(tmp_path / "port.npz")])
    want = ref(argv + ["--output", str(tmp_path / "jax.npz")])
    assert got == want
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_info():
    got = port(["info"])
    assert got["backend"] == "cpu" and got["devices"] == ["cpu"] and got["torch"] == torch.__version__


def test_fusion_simulated_mmmg(tmp_path):
    """`--method mmmg` on test_fusion_simulated's run: the same iterations,
    x within 1e-4 of its max (f32, 4 iterations), PSNR within 1e-2 dB."""
    argv = ["fusion", "--simulated", "-np", "31", "--n-lambda", "16", "-nc", "1", "-nt", "3",
            "-ni", "4", "-hp", "10", "--method", "mmmg"]
    got = port(argv + ["-o", str(tmp_path / "port")])
    want = ref(argv + ["-o", str(tmp_path / "jax")])
    assert got["method"] == want["method"] == "mmmg" and got["niter"] == want["niter"] == 4
    assert abs(got["psnr_maps"] - want["psnr_maps"]) <= 1e-2
    px, jx = np.load(tmp_path / "port" / "res_x.npy"), np.load(tmp_path / "jax" / "res_x.npy")
    assert np.abs(px - jx).max() <= 1e-4 * np.abs(jx).max()


def test_rehearse_mmmg(tmp_path):
    """`rehearse --method mmmg` at the rehearsal's size: the report's
    numbers within TOL_REPORT of the JAX command's, and the reference's bars."""
    argv = ["rehearse", "--method", "mmmg"] + REHEARSE
    got = port(argv + ["-w", str(tmp_path / "port")])
    want = ref(argv + ["-w", str(tmp_path / "jax")])
    assert list(got) == list(want)
    for k in want:
        if k not in NOT_COMPARED and not isinstance(want[k], str):
            assert abs(got[k] - want[k]) <= TOL_REPORT, (k, got[k], want[k])
    assert got["residual_rel"] < 0.10 and 0.9 < got["flux_ratio_median"] < 1.1
    assert got["flux_shape_corr"] > 0.9 and got["flux_points"] > 50


SHARDED = ["fusion", "--simulated", "--sharded", "-np", "31", "--n-lambda", "16", "-nc", "2",
           "-nt", "3", "-ni", "4", "-hp", "10"]


def test_fusion_sharded_matches_reference(tmp_path):
    """The sharded solve starts from zero maps, as the reference's does."""
    got = port(SHARDED + ["-o", str(tmp_path / "port")])
    want = ref(SHARDED + ["-o", str(tmp_path / "jax")])
    assert list(got) == list(want) and got["niter"] == want["niter"] == 4
    assert abs(got["psnr_maps"] - want["psnr_maps"]) <= 1e-2
    px, jx = np.load(tmp_path / "port" / "res_x.npy"), np.load(tmp_path / "jax" / "res_x.npy")
    assert px.shape == jx.shape and np.abs(px - jx).max() <= 1e-4 * np.abs(jx).max()
    for f in ("res_cube.npy", "criterion.npy"):
        assert os.path.exists(tmp_path / "port" / f)


def test_fusion_sharded_checkpoint_segments(tmp_path):
    """--checkpoint-every: segments that carry the lcg state give the
    uninterrupted run's bits; the checkpoint is written."""
    port(SHARDED + ["-o", str(tmp_path / "whole")])
    port(SHARDED + ["--checkpoint-every", "3", "-o", str(tmp_path / "seg")])
    np.testing.assert_array_equal(np.load(tmp_path / "seg" / "res_x.npy"),
                                  np.load(tmp_path / "whole" / "res_x.npy"))
    assert os.path.exists(tmp_path / "seg" / "solver_state.npz")


def test_fusion_sharded_under_torchrun(tmp_path):
    """Two ranks under torchrun on the CPU: rank 0 alone prints the report
    and writes; the result is world 1's to f32 rounding (another sum order)."""
    import subprocess
    import sys

    port(SHARDED + ["-o", str(tmp_path / "w1")])
    env = dict(os.environ, SURFH_CPU="1", OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "surfh_tpu_torch.cli"] + SHARDED + ["-o", str(tmp_path / "w2")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    reports = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(reports) == 1 and reports[0]["niter"] == 4
    x1, x2 = np.load(tmp_path / "w1" / "res_x.npy"), np.load(tmp_path / "w2" / "res_x.npy")
    assert np.abs(x2 - x1).max() <= 1e-4 * np.abs(x1).max()


def _write_raw(path, cards):
    """A raw-exposure stand-in: an empty primary HDU, then a float32 SCI HDU
    whose header holds the pointing keywords (tests/test_metadata.py)."""
    from surfh_tpu_torch.preprocessing.fits_io import CARD, _format_card, _pad_block

    def header(cs):
        return _pad_block(b"".join([_format_card(k, v) for k, v in cs] + [b"END".ljust(CARD)]))

    buf = header([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0)])
    buf += header([("XTENSION", "IMAGE"), ("BITPIX", -32), ("NAXIS", 2), ("NAXIS1", 4),
                   ("NAXIS2", 4), ("EXTNAME", "SCI")] + list(cards))
    buf += _pad_block(np.zeros((4, 4), ">f4").tobytes(), b"\x00")
    path.write_bytes(buf)


def _metadata_tree(root):
    from surfh_tpu_torch.preprocessing import fits_write

    raw, corr, filt = root / "raw", root / "corr", root / "filt"
    for d in (raw, corr, filt):
        d.mkdir(parents=True)
    _write_raw(raw / "ch1a_ch2a_0210j_00001_mirifushort_cal.fits",
               [("RA_V1", 83.83), ("DEC_V1", -5.42), ("PA_V3", 90.0)])
    _write_raw(raw / "ch3a_ch4a_0210j_00002_mirifulong_cal.fits",
               [("RA_V1", 83.9), ("DEC_V1", -5.4), ("PA_V3", 100.0)])
    fits_write(str(corr / "ch1a_00001_corr.fits"), np.ones((3, 3)), header={"BAND": "SHORT"})
    fits_write(str(corr / "ch2a_00001_corr.fits"), np.ones((3, 3)))
    data = np.arange(2 * 17 * 24, dtype=np.float32).reshape(2, 17 * 24)
    fits_write(str(filt / "ch2a_00001_filt.fits"), data, header={"PA_V3": 10.0, "BAND": "MEDIUM"})
    fits_write(str(filt / "ch3b_00002_filt.fits"), np.ones((3, 3)), header={"PA_V3": 0.0})
    fits_write(str(filt / "ch1a_00001_filt.fits"), data)


METADATA = {
    "targ-coords": ["--raw-dir", "{r}/raw", "--slice-dir", "{r}/corr", "--slice-dir", "{r}/filt"],
    "rotation": ["--raw-dir", "{r}/raw", "--slice-dir", "{r}/filt"],
    "swap-slits": ["--slice-dir", "{r}/filt"],
    "rank-target": ["--raw-dir", "{r}/raw", "--ref-ra", "83.9", "--ref-dec", "-5.4"],
}


def _tree_contents(root):
    from surfh_tpu_torch.preprocessing import fits_open

    out = {}
    for d in ("raw", "corr", "filt"):
        for f in sorted(os.listdir(root / d)):
            hdus = fits_open(str(root / d / f))
            out[f"{d}/{f}"] = [(dict(h.header), None if h.data is None else np.asarray(h.data))
                               for h in hdus]
    return out


@pytest.mark.parametrize("op", list(METADATA))
def test_metadata_matches_reference(tmp_path, op):
    """Both commands on copies of one tree: the same JSON (paths relative to
    their tree), then the same headers and data in every file."""
    for side in ("port", "jax"):
        _metadata_tree(tmp_path / side)
    opts = {side: [a.format(r=tmp_path / side) for a in METADATA[op]] for side in ("port", "jax")}
    got = port(["metadata", op] + opts["port"])
    want = ref(["metadata", op] + opts["jax"])
    if op == "rank-target":
        for rep, side in ((got, "port"), (want, "jax")):
            for e in rep["ranked"]:
                e["path"] = os.path.relpath(e["path"], tmp_path / side)
        assert len(want["ranked"]) == 2
    else:
        assert want["files_updated"] > 0
    assert got == want
    a, b = _tree_contents(tmp_path / "port"), _tree_contents(tmp_path / "jax")
    assert list(a) == list(b)
    for name in a:
        for (ha, da), (hb, db) in zip(a[name], b[name]):
            assert ha == hb, name
            assert (da is None and db is None) or np.array_equal(da, db), name


@pytest.mark.parametrize("argv", [["targ-coords"], ["rotation", "--raw-dir", "."],
                                  ["swap-slits"], ["rank-target", "--raw-dir", "."],
                                  ["no-such-op"]])
def test_metadata_usage_errors(argv):
    want = CliRunner().invoke(jax_cli, ["metadata"] + argv)
    with pytest.raises(SystemExit) as err:
        cli.main(["metadata"] + argv)
    assert err.value.code == want.exit_code == 2


def test_warmup_on_the_cpu(monkeypatch, tmp_path):
    # the flagship's 501² grid is too large for a CPU test: warm a 31² one
    from surfh_tpu_torch.simulation import flagship
    monkeypatch.setattr(flagship, "make_flagship_model",
                        functools.partial(flagship.make_flagship_model, npix=31))
    argv = ["warmup", "--bands", "1a", "--programs", "fwd,adj,normal",
            "--cache-dir", str(tmp_path / "cache")]
    first = port(argv)
    second = port(argv)
    assert first["kernels"] == "not built: cpu" and first["backend"] == "cpu"
    assert first["cache_dir"] == str(tmp_path / "cache")
    for rep in (first, second):
        for k in ("t_build_s", "t_tables_s", "t_first_fwd_s", "t_first_adj_s", "t_first_normal_s"):
            assert rep[k] >= 0.0, k
    assert (first["table_cache_hit"], second["table_cache_hit"]) == (False, True)
    assert any(f.startswith("tables_") for f in os.listdir(tmp_path / "cache"))
    with pytest.raises(SystemExit):
        cli.main(["warmup", "--programs", "fwd,bogus"])


DECONV = {
    "deconv2d": (["deconv2d", "-np", "41", "-ni", "20"], "deconv2d_x.npy", (41, 41)),
    "deconv-cube": (["deconv-cube", "-np", "41", "-nl", "4", "-ni", "15"], "deconv_cube_x.npy",
                    (4, 41, 41)),
}
TOL_PSNR = 1e-2  # dB: f32 CG in both packages; measured ≤ 1e-3


@pytest.mark.parametrize("geometry", ["--rectangle", "--rotated"])
@pytest.mark.parametrize("name", list(DECONV))
def test_deconv_matches_reference(tmp_path, name, geometry):
    """`deconv2d` and `deconv-cube` (once NotImplementedError, ROADMAP A10)
    at the JAX CLI tests' sizes (tests/test_cli.py:36-53), both geometries:
    the same JSON keys, iterations and λ planes, the output file, the psnr
    within TOL_PSNR of the JAX command's."""
    argv, out, shape = DECONV[name]
    argv = argv + [geometry]
    got = port(argv + ["-o", str(tmp_path / "port")])
    want = ref(argv + ["-o", str(tmp_path / "jax")])
    assert list(got) == list(want)
    assert got["niter"] == want["niter"] > 0
    assert got.get("n_lambda") == want.get("n_lambda")
    x = np.load(tmp_path / "port" / out)
    assert x.shape == np.load(tmp_path / "jax" / out).shape and np.isfinite(x).all()
    assert x.size == int(np.prod(shape))
    assert abs(got["psnr"] - want["psnr"]) <= TOL_PSNR, (got["psnr"], want["psnr"])


@pytest.mark.parametrize("argv", [["info"], ["fusion", "--simulated", "-np", "31"], ["rehearse"],
                                  ["allband", "-np", "31"], ["gen-psf", "--npix", "11"],
                                  ["deconv2d", "-np", "41"], ["deconv-cube", "-np", "41"],
                                  ["fusion", "--simulated", "--sharded", "-np", "31"],
                                  ["warmup", "--bands", "1a"]])
def test_no_card_and_no_switch_raises(monkeypatch, tmp_path, argv):
    monkeypatch.delenv("SURFH_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_rehearsal_sweep(capsys):
    """`python -m surfh_tpu_torch.utils.rehearsal_sweep` at a small size: one
    line per (µ, iteration count), each with the rehearsal's numbers."""
    from surfh_tpu_torch.utils import rehearsal_sweep

    assert rehearsal_sweep.main(["--band", "1a", "--pointings", "2", "-np", "61", "--step", "0.17",
                                 "--lambda-subsample", "12", "--mu", "1,5e3", "--iters", "2,4"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("mu ")]
    assert [ln.split(":")[0] for ln in lines] == ["mu 1 iterations 2", "mu 1 iterations 4",
                                                  "mu 5000 iterations 2", "mu 5000 iterations 4"]
    assert all("flux_ratio_median" in ln and "residual_rel" in ln for ln in lines)


@pytest.mark.parametrize("opd", ["none", "commissioning", "npy"])
def test_gen_psf_matches_reference(tmp_path, opd):
    from surfh_tpu_torch.utils.jwst_psf import zernike_opd

    np.save(tmp_path / "lam.npy", np.array([5.3, 8.0, 11.5]))
    argv = ["gen-psf", "-w", str(tmp_path / "lam.npy"), "--npix", "45", "--n-pupil", "96",
            "--pixelscale", "0.05"]
    if opd == "commissioning":
        argv += ["--opd", "commissioning"]
    elif opd == "npy":
        np.save(tmp_path / "opd.npy", zernike_opd(96, {4: 400e-9}) * 1e9)
        argv += ["--opd", str(tmp_path / "opd.npy"), "--opd-unit", "nm"]
    got = port(argv + ["-o", str(tmp_path / "port.npy")])
    want = ref(argv + ["-o", str(tmp_path / "jax.npy")])
    assert list(got) == list(want)
    for k in ("n_lambda", "npix", "pixelscale", "opd_rms_nm"):
        assert got[k] == want[k], k
    assert (got["opd_rms_nm"] > 0) == (opd != "none")
    a, b = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert a.shape == b.shape == (3, 45, 45) and a.dtype == np.float32
    assert float(np.abs(a - b).max() / np.abs(b).max()) <= 1e-5


def test_gen_psf_defaults_to_the_band_table(tmp_path, monkeypatch):
    """Without `-w` the axis is the band's detector table (band 1c by
    default): checked on a cut table, whose planes the port computes."""
    from surfh_tpu_torch import cli as tcli
    from surfh_tpu_torch.instrument.wavelength_mrs import get_mrs_wavelength

    seen = {}

    def fake_stack(wavels, scale, **kw):
        seen.update(wavels=np.asarray(wavels), scale=scale, **kw)
        return np.zeros((len(wavels), kw["npix"], kw["npix"]), np.float32)

    import surfh_tpu_torch.utils.jwst_psf as jp

    monkeypatch.setattr(jp, "psf_stack", fake_stack)
    rep = port(["gen-psf", "--npix", "3", "-o", str(tmp_path / "p.npy")])
    np.testing.assert_array_equal(seen["wavels"], get_mrs_wavelength("1c"))
    assert rep["n_lambda"] == len(get_mrs_wavelength("1c")) and rep["npix"] == 3
    assert (seen["scale"], seen["n_pupil"], seen["oversample"], seen["opd"]) == (0.025, 256, 1, None)
    args = tcli.build_parser().parse_args(["gen-psf"])
    assert (args.band, args.npix, args.pixelscale, args.output) == ("1c", 501, 0.025, "psf.npy")
    # every subcommand of the reference is the port's now (metadata and warmup were the last)
    sub = next(a for a in tcli.build_parser()._actions if a.dest == "command")
    assert set(jax_cli.commands) <= set(sub.choices) and not hasattr(tcli, "NOT_PORTED")
