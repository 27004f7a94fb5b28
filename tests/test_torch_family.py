"""surfh_tpu_torch's single-stage operator family against the JAX package
(CPU, float64), at the reference suite's size (tests/test_family.py:
`make_setup(im_size=41, n_lambda=30, n_tpl=3, n_channels=2,
n_pointings=2, n_slit=3)`), inputs from a NumPy seed.

* every operator of `scripts/run_operator_demo.py`'s list: forward and
  derived adjoint ≤1e-12 relative to the JAX operator's, and the port's
  own dot test at the reference's RTOL (1e-10);
* the reference suite's other checks, one counterpart each: R's and SCT's
  mapsToCube, SCT and LST against their staged compositions, MO_ST's
  pointing axis and its zero dither against ST, the SCT solve demo (the
  reference's residual bar, and the iterate against the JAX solve's),
  shift-conv at the origin against the regridding model, and the
  reference-name aliases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.models import family as jfam
from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
from surfh_tpu_torch.core.linop import dottest
from surfh_tpu_torch.models import family
from surfh_tpu_torch.simulation.synthetic import make_setup

torch.set_num_threads(2)

RTOL = 1e-10  # the reference's dot-test bar (float64: transposes exact to rounding)
OP_RTOL = 1e-12  # the port against the JAX package, float64
SETUP = dict(im_size=41, n_lambda=30, n_tpl=3, n_channels=2, n_pointings=2, n_slit=3)

# run_operator_demo.py's OPS, each with its constructor's trailing arguments
OPS = {
    "T": "maps", "C": "maps", "CT": "", "ST": "one", "ST_NN": "one", "SCT": "one", "LT": "one",
    "LST": "one", "MO_ST": "pts", "R": "one", "RL": "one", "RLT": "one", "SigRLT": "one",
    "SigRLCT": "one", "SigRLSCT": "one", "SigRLSCT_NN": "one", "MO_SigRLSCT": "pts",
    "MO_SigRLSCT_shiftConv": "pts", "MCMO_SigRLSCT": "mcmo", "MCMO_SigRLSCT_NN": "mcmo",
}
CLASS = {"ST_NN": "SpectroSnearestT", "SigRLSCT": "SpectroSigRLSCT1C",
         "SigRLSCT_NN": "SpectroSigRLSCT1C_NN", "MO_SigRLSCT": "MO_SigRLSCT",
         "MO_SigRLSCT_shiftConv": "MO_SigRLSCT_shiftConv", "MCMO_SigRLSCT": "MCMO_SigRLSCT",
         "MCMO_SigRLSCT_NN": "MCMO_SigRLSCT_NN"}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def fx():
    return make_setup(**SETUP)


@pytest.fixture(scope="module")
def jfx():
    return jax_make_setup(**SETUP)


def build(name: str, s: dict, port: bool):
    """The operator `name` of either package on setup `s`, float64 (the
    port's on the CPU), as run_operator_demo.py builds it."""
    mod = family if port else jfam
    cls = getattr(mod, CLASS.get(name, f"Spectro{name}"))
    kw = dict(dtype=torch.float64, device="cpu") if port else dict(dtype=jnp.float64)
    a = (s["sotf"], s["templates"], s["alpha_axis"], s["beta_axis"], s["wavelength_axis"])
    kind = OPS[name]
    if kind == "maps":
        args = ((s["maps"], s["templates"], s["wavelength_axis"]) if name == "T"
                else (s["sotf"], s["maps"], s["templates"], s["wavelength_axis"]))
    elif kind == "":
        args = a
    elif kind == "one":
        args = a + (s["instrs"][0], s["step_degree"])
    elif kind == "pts":
        args = a + (s["instrs"][0], s["step_degree"], s["pointings"][0])
    else:
        args = a + (s["instrs"], s["step_degree"], s["pointings"])
    if kind == "mcmo" and port:
        return cls(*args, dtype=np.float64).to("cpu", torch.float64)
    return cls(*args, **kw)


def test_setups_are_the_same(fx, jfx):
    for k in ("maps", "templates", "sotf", "alpha_axis", "beta_axis", "wavelength_axis"):
        np.testing.assert_array_equal(fx[k], jfx[k])


@pytest.mark.parametrize("name", list(OPS))
def test_operator_matches_jax(fx, jfx, name):
    """Forward and derived adjoint ≤1e-12 of the JAX operator's."""
    op, jop = build(name, fx, True), build(name, jfx, False)
    assert tuple(op.ishape) == tuple(jop.ishape) and tuple(op.oshape) == tuple(jop.oshape)
    rng = np.random.default_rng(7)
    x, y = rng.standard_normal(op.ishape), rng.standard_normal(op.oshape)
    assert rel(op.forward(x).numpy().ravel(), np.asarray(jop.forward(x)).ravel()) <= OP_RTOL
    assert rel(op.adjoint(y).numpy().ravel(), np.asarray(jop.adjoint(y)).ravel()) <= OP_RTOL


@pytest.mark.parametrize("name", list(OPS))
def test_dottest(fx, name):
    """The port's own dot test at the reference's RTOL (test_family.py's
    `test_<op>_dottest`)."""
    assert dottest(build(name, fx, True), rtol=RTOL)


def test_R_maps_to_cube(fx, jfx):
    op, jop = build("R", fx, True), build("R", jfx, False)
    cube = op.mapsToCube(fx["maps"])
    assert tuple(cube.shape) == op.ishape
    assert rel(cube.numpy(), np.asarray(jop.mapsToCube(jfx["maps"]))) <= OP_RTOL
    assert rel(op.cubeTomaps(cube).numpy(), np.asarray(jop.cubeTomaps(np.asarray(cube)))) <= OP_RTOL


def test_SCT_matches_staged_composition(fx):
    """SCT forward == S (SpectroST with identity templates) after CT."""
    n_lam = len(fx["wavelength_axis"])
    a = (fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"], fx["wavelength_axis"])
    kw = dict(dtype=torch.float64, device="cpu")
    sct = family.SpectroSCT(*a, fx["instrs"][0], fx["step_degree"], **kw)
    ct = family.SpectroCT(*a, **kw)
    s_only = family.SpectroST(fx["sotf"], np.eye(n_lam), *a[2:], fx["instrs"][0], fx["step_degree"],
                              **kw)
    staged = s_only.forward(ct.forward(fx["maps"])).numpy()
    np.testing.assert_allclose(sct.forward(fx["maps"]).numpy(), staged, rtol=1e-10, atol=1e-12)
    assert tuple(sct.mapsToCube(fx["maps"]).shape) == (n_lam,) + fx["maps"].shape[1:]


def test_LST_matches_staged_composition(fx):
    """LST forward == L∘S (SpectroLT with identity templates) on the mixed cube."""
    n_lam = len(fx["wavelength_axis"])
    a = (fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"], fx["wavelength_axis"])
    kw = dict(dtype=torch.float64, device="cpu")
    lst = family.SpectroLST(*a, fx["instrs"][0], fx["step_degree"], **kw)
    ls_only = family.SpectroLT(fx["sotf"], np.eye(n_lam), *a[2:], fx["instrs"][0],
                               fx["step_degree"], **kw)
    staged = ls_only.forward(lst.mapsToCube(fx["maps"])).numpy()
    np.testing.assert_allclose(lst.forward(fx["maps"]).numpy(), staged, rtol=1e-10, atol=1e-12)


def test_MO_ST_pointing_axis_and_origin_matches_ST(fx):
    from surfh_tpu_torch.instrument.geometry import Coord, CoordList

    mo = build("MO_ST", fx, True)
    assert mo.oshape[0] == len(fx["pointings"][0])
    a = (fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"], fx["wavelength_axis"],
         fx["instrs"][0], fx["step_degree"])
    kw = dict(dtype=torch.float64, device="cpu")
    mo0 = family.SpectroMO_ST(*a, CoordList([Coord(0.0, 0.0)]), **kw)
    st = family.SpectroST(*a, **kw)
    np.testing.assert_allclose(mo0.forward(fx["maps"])[0].numpy(), st.forward(fx["maps"]).numpy(),
                               rtol=1e-10, atol=1e-12)


def test_SCT_solve_demo(fx, jfx):
    """The reference's SCT fusion demo (test_family.py::test_SCT_solve_demo):
    y = SCT(maps), 60 lcg iterations on the quadratic criterion, the data
    residual under 5 % of ‖y‖ — and 5 iterations' iterate against the
    JAX solve's (at µ = 1e-4 CG amplifies the packages' 1e-16 rounding
    differences ~10⁴× every 5 iterations past ~8)."""
    from surfh_tpu.solvers.criterion import QuadCriterion_MRS as JaxCrit
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

    op, jop = build("SCT", fx, True), build("SCT", jfx, False)
    y = op.forward(fx["maps"])
    res = QuadCriterion_MRS(1.0, y, op, mu_reg=1e-4).run_method("lcg", 60, value_init=0.0)
    x = res.x.numpy()
    resid = float(np.linalg.norm(op.forward(x).numpy() - y.numpy()))
    assert resid < 0.05 * float(np.linalg.norm(y.numpy())) and x.shape == op.ishape
    early = QuadCriterion_MRS(1.0, y, op, mu_reg=1e-4).run_method("lcg", 5, value_init=0.0)
    jres = JaxCrit(1.0, np.asarray(jop.forward(jfx["maps"])), jop, mu_reg=1e-4).run_method(
        "lcg", 5, value_init=0.0)
    assert rel(early.x.numpy(), np.asarray(jres.x)) <= OP_RTOL


def test_shiftConv_matches_gridding_at_origin(fx):
    from surfh_tpu_torch.instrument.geometry import Coord, CoordList

    pts = CoordList([Coord(0.0, 0.0)])
    a = (fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"], fx["wavelength_axis"],
         fx["instrs"][0], fx["step_degree"], pts)
    kw = dict(dtype=torch.float64, device="cpu")
    ya = family.MO_SigRLSCT(*a, **kw).forward(fx["maps"]).numpy()
    yb = family.MO_SigRLSCT_shiftConv(*a, **kw).forward(fx["maps"]).numpy()
    np.testing.assert_allclose(ya, yb, rtol=1e-8, atol=1e-10)


def test_reference_name_aliases():
    """Every reference alias of the JAX family names the port's counterpart."""
    names = [n for n in dir(jfam) if n.startswith("spectro")]
    assert len(names) == 20
    for name in names:
        target = getattr(jfam, name).__name__
        assert getattr(family, name).__name__ == target, name


def test_float32_operator_matches_float64(fx):
    """The port's float32 operator (the card's type) against its float64 one."""
    x = np.random.default_rng(3).random(build("SigRLCT", fx, True).ishape)
    y32 = family.SpectroSigRLCT(fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"],
                                fx["wavelength_axis"], fx["instrs"][0], fx["step_degree"],
                                device="cpu").forward(x)
    assert y32.dtype == torch.float32
    assert rel(y32.numpy(), build("SigRLCT", fx, True).forward(x).numpy()) <= 1e-5
