"""The plain reference against the program in float64 on the CPU at a toy
size (two bands of different MIRI channels, 101² sky, 2 pointings; a 41²
sky where the unknown is the cube), the reference's transpose against its
forward (the dot test), and the kinds' reference answers against the
reference's own solve."""

import numpy as np
import pytest
import torch

from benchmark.bench import check, program
from benchmark.reference import instrument
from benchmark.reference.operator import Reference, cg_solve, dtd

PROBLEM = dict(npix=101, bands=["1c", "2c"], n_pointings=2, n_tpl=4, lambda_subsample=9,
               setup_seed=19940407, step_arcsec=0.025, psf_stamp=40)
# the W-plane OTF of the program is complex64 even in a float64 model
RANK = dict(window_local=True, conv_rank_rtol=1e-7, conv_freq_rtol=1e-6)
CASES = {
    "rank": (dict(RANK, wblur_impl="dense", wblur_band_rtol=0.0), dict(), 1e-10),
    "rank-freq-cut": (dict(RANK, conv_rank_rtol=0.0, conv_freq_rtol=1e-3), dict(conv_rank_rtol=0.0,
                                                                               conv_freq_rtol=1e-3), 1e-10),
    "wplane-banded": (dict(wblur_impl="banded", wblur_band_rtol=1e-4),
                      dict(window_local=False, wblur_impl="banded", wblur_band_rtol=1e-4), 1e-7),
}


def program_model(kw):
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup

    setup = make_flagship_setup(npix=101, bands=PROBLEM["bands"], n_pointings=2, lambda_subsample=9,
                                build_sotf=not kw.get("window_local", True), device="cpu")
    model, _ = make_flagship_model(setup, dtype=np.float64, **kw)
    return model.to("cpu", torch.float64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_program(case):
    ref_model, prog_kw, tol = CASES[case]
    ref = Reference({"problem": PROBLEM, "model": ref_model}, "cpu", torch.float64)
    model = program_model(prog_kw)
    x = torch.as_tensor(np.random.default_rng(5).random((4, 101, 101)))
    ys = ref.forward(x)
    yp = model.forward(x)
    yr = torch.cat([y.reshape(-1) for y in ys])
    assert float((yp - yr).norm() / yr.norm()) < tol
    v = torch.as_tensor(np.random.default_rng(6).standard_normal(yr.numel()))
    vs = [b.view(y.shape) for b, y in zip(torch.split(v, [y.numel() for y in ys]), ys)]
    ar, ap = ref.adjoint(vs), model.adjoint(v)
    assert float((ap - ar).norm() / ar.norm()) < 2 * tol


def test_reference_transpose_is_exact():
    ref = Reference({"problem": PROBLEM, "model": {"wblur_impl": "banded", "wblur_band_rtol": 1e-4}},
                    "cpu", torch.float64)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal(ref.x_shape))
    ys = ref.forward(x)
    vs = [torch.as_tensor(rng.standard_normal(y.shape)) for y in ys]
    lhs = sum(float((y * v).sum()) for y, v in zip(ys, vs))
    rhs = float((x * ref.adjoint(vs, "wpsf")).sum())
    assert abs(lhs - rhs) <= 1e-11 * abs(lhs)


def test_banded_masks_are_the_program_plans():
    from surfh_tpu_torch.core.wblur_banded import build_band_plan, build_band_plan_t

    inp = instrument.problem_inputs(PROBLEM)
    for band in PROBLEM["bands"]:
        g = instrument.band_geometry(band, inp)
        wpsf = g.wpsf(inp["wavel"], inp["beta"][1] - inp["beta"][0])
        fwd, adj = instrument.banded_masks(wpsf, 1e-4)
        assert np.array_equal(fwd, build_band_plan(wpsf, rel_eps=1e-4).mask())
        assert np.array_equal(adj, build_band_plan_t(wpsf, rel_eps=1e-4).mask())


def test_cg_solve_lowers_the_criterion():
    ref = Reference({"problem": PROBLEM, "model": {}}, "cpu", torch.float64)
    x_true = torch.as_tensor(np.random.default_rng(8).random(ref.x_shape))
    y = ref.forward(x_true)

    def crit(x):
        r = [yy - hx for yy, hx in zip(y, ref.forward(x))]
        return sum(float((d * d).sum()) for d in r) / 2 + 5e3 * float((x * dtd(x)).sum()) / 2

    x0 = torch.full(ref.x_shape, 0.5, dtype=torch.float64)
    j = [crit(cg_solve(ref, y, 1.0, 5e3, 0.5, n)) for n in (0, 2, 5)]
    assert j[0] == pytest.approx(crit(x0)) and j[0] > j[1] > j[2]


CUBE = dict(PROBLEM, npix=41, lambda_subsample=30, unknown="cube")
BANDED = {"wblur_impl": "banded", "wblur_band_rtol": 1e-4}


def test_cube_reference_matches_the_program():
    """T = I: the reference's cube route against the program's cube-mode
    W-plane model (`templates=None`), both in float64, the program's OTF
    built in complex128 by its own `ir2fr_device`."""
    from surfh_tpu_torch.core.fft import ir2fr_device
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup

    ref = Reference({"problem": CUBE, "model": BANDED}, "cpu", torch.float64)
    setup = make_flagship_setup(npix=41, bands=CUBE["bands"], n_pointings=2, lambda_subsample=30, device="cpu")
    setup = dict(setup, templates=None,
                 sotf=ir2fr_device(setup["psf_stack"], (41, 41), "cpu", dtype=torch.complex128))
    model, _ = make_flagship_model(setup, dtype=np.float64, window_local=False, **BANDED)
    model = model.to("cpu", torch.float64)
    assert model.ishape == ref.x_shape == (len(instrument.problem_inputs(CUBE)["wavel"]), 41, 41)
    x = torch.as_tensor(np.random.default_rng(5).random(ref.x_shape))
    ys = ref.forward(x)
    yr = torch.cat([y.reshape(-1) for y in ys])
    assert float((model.forward(x) - yr).norm() / yr.norm()) <= 1e-10
    v = torch.as_tensor(np.random.default_rng(6).standard_normal(yr.numel()))
    ar = ref.adjoint([b.view(y.shape) for b, y in zip(torch.split(v, [y.numel() for y in ys]), ys)])
    assert float((model.adjoint(v) - ar).norm() / ar.norm()) <= 1e-10


def test_cube_reference_transpose_is_exact():
    ref = Reference({"problem": CUBE, "model": BANDED}, "cpu", torch.float64)
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.standard_normal(ref.x_shape))
    ys = ref.forward(x)
    vs = [torch.as_tensor(rng.standard_normal(y.shape)) for y in ys]
    lhs = sum(float((y * v).sum()) for y, v in zip(ys, vs))
    rhs = float((x * ref.adjoint(vs, "wpsf")).sum())
    assert abs(lhs - rhs) <= 1e-11 * abs(lhs)


def test_a_window_local_cube_is_refused():
    with pytest.raises(ValueError, match="W-plane"):
        Reference({"problem": CUBE, "model": RANK}, "cpu", torch.float64)


@pytest.mark.parametrize("kind", ["cg_solve", "normal_chain"])
def test_the_kinds_answer_as_the_reference_does(kind):
    """Maps mode: the kind's reference answer is the reference's own solve
    (or normal), bit for bit."""
    config = {"problem": PROBLEM, "model": BANDED, "criterion": {"mu_spectro": 1.0, "mu_reg": 5e3}}
    traffic = {"kind": kind, "method": "lcg", "value_init": 0.5, "maximum_iterations": 3}
    x = program.seed_unknown(config, 2**31 + 5, "cpu")
    ref = Reference(config, "cpu", torch.float64)
    x64 = x.to(torch.float64)
    direct = cg_solve(ref, ref.forward(x64), 1.0, 5e3, 0.5, 3) if kind == "cg_solve" else ref.normal(x64)
    assert torch.equal(check.reference_answer(config, traffic, x, "cpu"), direct)
    if kind == "cg_solve":
        with pytest.raises(ValueError, match="plain CG"):
            check.reference_answer(config, dict(traffic, method="mmmg"), x, "cpu")


@pytest.mark.parametrize("problem", [PROBLEM, CUBE], ids=["maps", "cube"])
def test_the_unknown_is_drawn_from_the_seed(problem):
    """Maps: the generator calls of the maps' draw before the unknown had a
    mode, bit for bit; cube: [L, N, N] in [0, 1)."""
    x = program.seed_unknown({"problem": problem}, 2**31 + 5, "cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(2**31 + 5)
    if problem is PROBLEM:
        old = torch.rand((problem["n_tpl"], problem["npix"], problem["npix"]), generator=gen, device="cpu",
                         dtype=torch.float32)
        assert torch.equal(x, old)
    else:
        assert x.shape == instrument.problem_inputs(problem)["x_shape"] and x.dtype == torch.float32
        assert 0 <= float(x.min()) and float(x.max()) < 1
