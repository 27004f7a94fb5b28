"""surfh_tpu_torch's window-local operator in every conv mode against the
JAX reference (CPU, float64, inputs from numpy seeds; the reference's
fixtures of tests/test_window_local.py:19-31 and :204-271).

* the dense window-local conv functions of `core.fft` (`otf_from_stamps`,
  `otf_freq_support`, `conv_otf_matmul(_t)`, `lmm_conv_otf_matmul(_t)`,
  `lowrank_stamp_factor(rmax=)`) against the reference's ≤1e-12, and the
  port's own dot tests of each pair ≤1e-12;
* the models: dense stamps (`conv_rank_rtol=0`, truncated and full
  spectrum), the OTF-window tables (matmul, truncated and a view of the
  sotf; fft), a mixed model (one channel's rank gate open, two declined),
  cube mode (``templates=None``) window-local in both table kinds and with
  the FFT conv, and the W-plane cube mode: forward, adjoint and normal
  against the reference's programs ≤1e-12, the port's dot test ≤1e-12 and
  its fused normal against adjoint∘forward ≤1e-12, the support records and
  the gate as the reference's;
* `convert`: the reference's host tables carried across equal the port's
  own (bit for bit), and the model on them gives the reference's operator;
* the host-table disk cache: a hit is bit-equal to the cold build, the key
  changes with the conv configuration, ``SURFH_TABLE_CACHE=0`` turns it
  off, OTF-window models are not cached;
* the repairs: `make_model` takes the reference's parameters and defaults
  (C5: `make_model(setup)` is the reference's exact materialized-OTF model,
  ≤1e-12), and the all-band pipeline's window-local model is the
  reference's OTF-window model over the setup's sotf (C6, ≤1e-12 in f64;
  its float32 solve stage is held in tests/test_torch_allband.py).
"""

import inspect
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core import fft as jfft
from surfh_tpu.models.spectro import SpectroSigRLSCT as JaxSpectro
from surfh_tpu.simulation import flagship as jflagship
from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
from surfh_tpu_torch.convert import (host_tables_from_reference, tables_from_reference,
                                     wplane_tables_from_reference)
from surfh_tpu_torch.core import fft
from surfh_tpu_torch.core.gather_rows import RowGatherPlan
from surfh_tpu_torch.models.spectro import SpectroSigRLSCT
from surfh_tpu_torch.simulation import flagship
from surfh_tpu_torch.simulation.synthetic import make_model, make_setup

torch.set_num_threads(2)

TOL = 1e-12
KW = dict(im_size=41, n_lambda=36, n_tpl=3, n_channels=2, n_pointings=2, n_slit=3)
RKW = dict(im_size=41, n_lambda=120, n_tpl=2, n_channels=2, n_pointings=2, n_slit=3)
# three bands, the middle one's window wider: its rank gate opens, the others' decline
MIXED = dict(im_size=41, n_lambda=36, n_tpl=2, n_channels=3, n_pointings=2, n_slit=3,
             band_overlap=0.5)
STAMPS = dict(psf_stamps=True, conv_impl="matmul")

# name: (setup sizes, model keywords, cube mode)
CONFIGS = {
    "dense_stamps": (RKW, dict(STAMPS, conv_freq_rtol=1e-6, conv_rank_rtol=0.0), False),
    "dense_stamps_full": (KW, dict(STAMPS), False),
    "otf_matmul": (KW, dict(conv_impl="matmul", conv_freq_rtol=1e-6), False),
    "otf_matmul_view": (KW, dict(conv_impl="matmul"), False),
    "otf_fft": (KW, dict(conv_impl="fft"), False),
    "mixed": (MIXED, dict(STAMPS, conv_freq_rtol=1e-6, conv_rank_rtol=1e-7), False),
    "cube_stamps": (KW, dict(STAMPS, conv_freq_rtol=1e-6), True),
    "cube_otf_matmul": (KW, dict(conv_impl="matmul", conv_freq_rtol=1e-6), True),
    "cube_otf_fft": (KW, dict(conv_impl="fft"), True),
    "cube_wplane": (KW, dict(window_local=False), True),
}


def rel(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _t(a):
    return torch.as_tensor(np.array(a))  # a writable copy of a reference array


# ---------------------------------------------------------------------------
# core.fft


@pytest.fixture(scope="module")
def conv_inputs():
    rng = np.random.default_rng(0)
    na, nb, w, m = 23, 20, 7, 3
    dm = jfft.dft_matmul_tables((na, nb), np.float64, ka_max=6, kb_keep=5, bbox=(3, 4, 9, 8))
    st = jfft.psf_stamp_tables((na, nb), (5, 5), np.float64, ka_max=6, kb_keep=5)
    psf = rng.random((w, 5, 5))
    o_re, o_im = (np.asarray(a) for a in jfft.otf_from_stamps(jnp.asarray(psf), st))
    return SimpleNamespace(
        dm=dm, m={k: _t(v) for k, v in dm.items()}, st=st, psf=psf, o=(o_re, o_im),
        ot=(_t(o_re), _t(o_im)), maps=rng.random((m, na, nb)), tpl=rng.random((m, w)),
        x=rng.random((w, na, nb)), g=rng.random((w, 9, 8)))


def test_otf_from_stamps_matches_reference(conv_inputs):
    c = conv_inputs
    got = fft.otf_from_stamps(_t(c.psf), {k: _t(v) for k, v in c.st.items()}, chunk=3)
    assert rel(got[0], c.o[0]) <= TOL and rel(got[1], c.o[1]) <= TOL


@pytest.mark.parametrize("name", ["lmm_conv_otf_matmul", "lmm_conv_otf_matmul_t", "conv_otf_matmul",
                                  "conv_otf_matmul_t"])
def test_dense_conv_matches_reference(conv_inputs, name):
    c = conv_inputs
    arg = {"lmm_conv_otf_matmul": c.maps, "conv_otf_matmul": c.x}.get(name, c.g)
    lmm_ = name.startswith("lmm")
    want = getattr(jfft, name)(arg, *((c.tpl,) if lmm_ else ()), *c.o, c.dm)
    got = getattr(fft, name)(_t(arg), *((_t(c.tpl),) if lmm_ else ()), *c.ot, c.m)
    assert got.shape == tuple(np.shape(want))
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("kind", ["lmm", "cube"])
def test_dense_conv_rows_dot_test(conv_inputs, kind):
    c = conv_inputs
    if kind == "lmm":
        x = _t(c.maps)
        fwd = fft.lmm_conv_otf_rows(x, _t(c.tpl), *c.ot, c.m)
    else:
        x = _t(c.x)
        fwd = fft.conv_otf_matmul_rows(x, *c.ot, c.m)
    assert fwd.shape == (9 * 8, 7) and fwd.is_contiguous()
    r = _t(np.random.default_rng(1).standard_normal(tuple(fwd.shape)))
    back = (fft.lmm_conv_otf_rows_t(r, _t(c.tpl), *c.ot, c.m) if kind == "lmm"
            else fft.conv_otf_matmul_rows_t(r, *c.ot, c.m))
    lhs, rhs = float(torch.sum(fwd * r)), float(torch.sum(x * back))
    assert abs(lhs - rhs) <= TOL * abs(lhs)


@pytest.mark.parametrize("source", ["numpy", "tensor"])
def test_otf_freq_support_matches_reference(source):
    rng = np.random.default_rng(2)
    otf = rng.random((9, 23, 11)) + 1j * rng.random((9, 23, 11))
    otf[:, 6:18] *= 1e-9
    otf[:, :, 8:] *= 1e-8
    want = jfft.otf_freq_support(otf, 1e-6)
    got = fft.otf_freq_support(otf if source == "numpy" else torch.as_tensor(otf), 1e-6, chunk=4)
    assert got[:2] == want[:2] == (5, 8)
    assert abs(got[2] - want[2]) <= 1e-15 * want[2]
    assert fft.otf_freq_support(otf, 0.0) == jfft.otf_freq_support(otf, 0.0) == (None, None, 0.0)


@pytest.mark.parametrize("rmax", [None, 1, 3])
def test_lowrank_stamp_factor_rmax(rmax):
    psf = np.random.default_rng(3).random((12, 5, 5))
    for a, b in zip(fft.lowrank_stamp_factor(psf, 1e-9, rmax=rmax),
                    jfft.lowrank_stamp_factor(psf, 1e-9, rmax=rmax)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the models against the reference


def _build(name):
    kw, model_kw, cube = CONFIGS[name]
    model_kw = dict(model_kw)
    window_local = model_kw.pop("window_local", True)
    jsetup, psetup = jax_make_setup(**kw), make_setup(**kw)
    if cube:
        jsetup, psetup = dict(jsetup, templates=None), dict(psetup, templates=None)
    jm, _ = jax_make_model(setup=jsetup, dtype=jnp.float64, window_local=window_local, **model_kw)
    pm, _ = make_model(setup=psetup, dtype=np.float64, window_local=window_local, **model_kw)
    return jsetup, psetup, jm, pm


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SURFH_TABLE_CACHE", "0")
        jsetup, psetup, jm, pm = _build(request.param)
        jtables = jm.device_tables() if jm.window_local else None
    pm.to("cpu", torch.float64)
    rng = np.random.default_rng(4)
    x = rng.random(pm.ishape) if CONFIGS[request.param][2] else np.array(psetup["maps"])
    return SimpleNamespace(name=request.param, jm=jm, pm=pm, jtables=jtables, jsetup=jsetup,
                           psetup=psetup, x=x, y=rng.standard_normal(pm.oshape))


def _reference(case, op, arg):
    jm = case.jm
    if not jm.window_local:
        return jm.forward(arg) if op == "forward" else jm.adjoint(arg)
    fn = {"forward": jm._forward_fn_tabled, "adjoint": jm._adjoint_fn_tabled,
          "normal": jm._normal_fn_tabled}[op]
    return jax.jit(fn)(jnp.asarray(arg), case.jtables)


@pytest.mark.parametrize("op", ["forward", "adjoint", "normal"])
def test_model_matches_reference(case, op):
    arg = case.y if op == "adjoint" else case.x
    if op == "normal" and not case.jm.window_local:
        want = case.jm.adjoint(case.jm.forward(arg))
    else:
        want = _reference(case, op, arg)
    got = getattr(case.pm, op)(torch.as_tensor(arg))
    assert tuple(got.shape) == tuple(np.shape(want))
    assert rel(got, want) <= TOL


def test_model_dot_test_and_fused_normal(case):
    pm = case.pm
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(pm.ishape))
    y = torch.as_tensor(rng.standard_normal(pm.oshape))
    hx, hty = pm.forward(x), pm.adjoint(y)
    lhs = float(torch.dot(hx, y))
    rhs = float(torch.dot(x.reshape(-1), hty.reshape(-1)))
    # relative to ‖Hx‖·‖y‖: the signed data make <Hx, y> itself a sum that cancels
    assert abs(lhs - rhs) <= TOL * float(hx.norm() * y.norm())
    assert rel(pm.normal(x), pm.adjoint(pm.forward(x))) <= TOL


def _kind(t: dict) -> tuple:
    """A channel's table kind: λ-rank, dense stamps or an OTF window, with
    or without DFT matrices."""
    kind = "rank" if "cu" in t else "stamps" if "psf" in t else "window"
    return kind, "dftm" in t


def test_model_tables_and_supports_match_reference(case):
    jm, pm = case.jm, case.pm
    assert pm.conv_impl == jm.conv_impl and pm.lmm == jm.lmm and pm.ishape == tuple(jm.ishape)
    if not jm.window_local:
        assert pm.conv_supports is None
        return
    jhost = jm.host_tables()
    assert pm.conv_supports == jm.conv_supports
    assert [_kind(t) for t in pm.host_tables()["chan"]] == [_kind(t) for t in jhost["chan"]]


def test_mixed_model_gate():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SURFH_TABLE_CACHE", "0")
        _, _, jm, pm = _build("mixed")
        jm.host_tables()
    assert ["cu" in t for t in pm.host_tables()["chan"]] == [False, True, False]
    assert ["cu" in t for t in jm.host_tables()["chan"]] == [False, True, False]


def test_maps_to_cube_as_the_reference(case):
    """T as the reference's: the same cube, or in cube mode (no templates)
    an error in both packages."""
    maps = np.random.default_rng(8).random((3,) + case.pm.imshape)
    if CONFIGS[case.name][2]:
        with pytest.raises(TypeError, match="cube mode"):
            case.pm.mapsToCube(maps)
        with pytest.raises((TypeError, AttributeError)):
            case.jm.mapsToCube(maps)
    else:
        maps = maps[: case.pm.ishape[0]]
        assert rel(case.pm.mapsToCube(torch.as_tensor(maps)), case.jm.mapsToCube(maps)) <= TOL


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_tree_equal(u, v, f"{path}[{i}]")
    elif isinstance(a, RowGatherPlan):
        assert a.n_src == b.n_src, path
        for f in ("row_ptr", "idx", "w", "dst"):
            _assert_tree_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif a is None or b is None:
        assert a is b, path
    else:
        u, v = np.asarray(a), np.asarray(b)
        assert u.shape == v.shape and u.dtype == v.dtype, (path, u.shape, v.shape, u.dtype, v.dtype)
        np.testing.assert_array_equal(u, v, err_msg=path)


def test_convert_round_trip(case):
    """The reference's host tables carried across are the port's own, bit
    for bit (window-local), and the model on them is the reference's
    operator (the W-plane cube mode through `wplane_tables_from_reference`,
    templates None)."""
    jm, pm = case.jm, case.pm
    if not jm.window_local:
        chans = [(c._wpsf_dev, c.slit_weights_sub, c._composed_stack, c._tbbox, None, None)
                 for c in jm.channels]
        tables = wplane_tables_from_reference(jm._sotf_dev, jm._templates_dev, chans, "cpu",
                                              torch.float64)
        assert tables["templates"] is None
        ref = _build(case.name)[3].to("cpu", torch.float64, tables=tables)
        assert rel(ref.forward(torch.as_tensor(case.x)), _reference(case, "forward", case.x)) <= TOL
        return
    stacks = [c._composed_stack for c in jm.channels]
    tbboxes = [c._tbbox for c in jm.channels]
    want = host_tables_from_reference(jm.host_tables(), stacks, tbboxes)
    _assert_tree_equal(pm.host_tables(), want)
    name = case.name
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SURFH_TABLE_CACHE", "0")
        ref = _build(name)[3].to("cpu", torch.float64, tables=tables_from_reference(
            jm.host_tables(), stacks, "cpu", torch.float64, tbboxes))
    got = ref.forward(torch.as_tensor(case.x))
    assert rel(got, _reference(case, "forward", case.x)) <= TOL


def test_convert_needs_the_bboxes_of_fft_channels():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SURFH_TABLE_CACHE", "0")
        jm = _build("otf_fft")[2]
    with pytest.raises(ValueError, match="tbboxes"):
        host_tables_from_reference(jm.host_tables(), [c._composed_stack for c in jm.channels])


def test_otf_window_is_a_view_of_the_sotf():
    """Without truncation each channel's window is the global sotf's own
    memory, on the host and on the device."""
    s = make_setup(**KW)
    s["sotf"] = torch.as_tensor(s["sotf"])
    pm, _ = make_model(setup=s, dtype=np.float64, window_local=True, conv_impl="matmul")
    pm.to("cpu", torch.float64)
    base = s["sotf"].untyped_storage().data_ptr()
    for t in pm.tables["chan"]:
        assert t["otf"][0].untyped_storage().data_ptr() == base
        assert t["otf"][1].untyped_storage().data_ptr() == base


# ---------------------------------------------------------------------------
# the host-table disk cache


def _stamp_model(**kw):
    return make_model(setup=make_setup(**RKW), dtype=np.float64, window_local=True,
                      **dict(dict(STAMPS, conv_freq_rtol=1e-6, conv_rank_rtol=1e-7), **kw))[0]


def test_table_cache_hit_is_bit_equal(monkeypatch, tmp_path):
    monkeypatch.setenv("SURFH_TABLE_CACHE", str(tmp_path))
    cold = _stamp_model()
    path = cold.table_cache_path()
    assert not cold.table_cache_hit and path.startswith(str(tmp_path))
    assert [p.name for p in tmp_path.iterdir()] == [path.split("/")[-1]]
    hit = _stamp_model()
    assert hit.table_cache_hit and hit.table_cache_path() == path
    _assert_tree_equal(hit.host_tables(), cold.host_tables())
    assert hit.conv_supports == cold.conv_supports
    assert [c.tbbox for c in hit.channels] == [c.tbbox for c in cold.channels]
    x = torch.as_tensor(make_setup(**RKW)["maps"])
    assert torch.equal(hit.to("cpu", torch.float64).normal(x), cold.to("cpu", torch.float64).normal(x))
    reused = _stamp_model(channels=cold.channels)
    assert reused.table_cache_hit and reused.channels[0] is cold.channels[0]


def test_unreadable_table_cache_is_rebuilt(monkeypatch, tmp_path):
    """A cache file that does not unpickle is built anew and overwritten."""
    monkeypatch.setenv("SURFH_TABLE_CACHE", str(tmp_path))
    path = _stamp_model().table_cache_path()
    with open(path, "wb") as fh:
        fh.write(b"not a pickle")
    rebuilt = _stamp_model()
    assert not rebuilt.table_cache_hit
    assert _stamp_model().table_cache_hit


def test_table_cache_key_follows_the_configuration(monkeypatch, tmp_path):
    monkeypatch.setenv("SURFH_TABLE_CACHE", str(tmp_path))
    base = _stamp_model().table_cache_path()
    assert _stamp_model(conv_rank_rtol=0.0).table_cache_path() != base
    assert _stamp_model(conv_freq_rtol=0.0).table_cache_path() != base
    assert make_model(setup=make_setup(**dict(RKW, n_pointings=1)), dtype=np.float64,
                      window_local=True, **STAMPS)[0].table_cache_path() != base
    assert len(list(tmp_path.iterdir())) == 4


def test_table_cache_switch_and_scope(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("SURFH_TABLE_CACHE", raising=False)
    assert _stamp_model().table_cache_path().startswith(str(tmp_path / "home" / ".cache" / "surfh_tpu_torch"))
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    m = _stamp_model()
    assert m.table_cache_path() is None and not m.table_cache_hit
    monkeypatch.setenv("SURFH_TABLE_CACHE", str(tmp_path / "c"))
    otf = make_model(setup=make_setup(**KW), dtype=np.float64, window_local=True, conv_impl="matmul")[0]
    wplane = make_model(setup=make_setup(**KW), dtype=np.float64)[0]
    assert otf.table_cache_path() is None and wplane.table_cache_path() is None
    assert not (tmp_path / "c").exists()


# ---------------------------------------------------------------------------
# the repairs


def test_make_model_takes_the_reference_parameters():
    """C5: the reference's parameters in its order with its defaults
    (C10: `dtype=None`, which builds float32 in both), then the port's
    `workers` and `channels`."""
    jp = list(inspect.signature(jax_make_model).parameters.values())
    pp = list(inspect.signature(make_model).parameters.values())
    assert [p.name for p in pp] == [p.name for p in jp[:-1]] + ["workers", "channels", "kwargs"]
    for p, j in zip(pp, jp[:-1]):
        assert p.default == j.default, p.name


def test_make_model_default_is_the_reference_model():
    """C5: `make_model(setup)` in both packages is the exact
    materialized-OTF model: the same forward and adjoint ≤1e-12 in f64."""
    jsetup, psetup = jax_make_setup(**KW), make_setup(**KW)
    jm, _ = jax_make_model(jsetup, jnp.float64)
    pm, _ = make_model(psetup, np.float64)
    assert not pm.window_local and pm.conv_impl == "fft" and pm.conv_supports is None
    pm.to("cpu", torch.float64)
    x = np.array(jsetup["maps"])
    y = np.random.default_rng(6).standard_normal(jm.oshape)
    assert rel(pm.forward(torch.as_tensor(x)), jm.forward(x)) <= TOL
    assert rel(pm.adjoint(torch.as_tensor(y)), jm.adjoint(y)) <= TOL


def test_allband_window_local_model_is_the_reference_model(monkeypatch, tmp_path):
    """C6: the all-band pipeline's window-local model is the reference's
    OTF-window model over the setup's sotf (no λ-rank, no port-only
    truncation): forward and adjoint ≤1e-12 in f64 against the reference's
    (its CPU `conv_impl="auto"` is the FFT conv, the port's the matmul
    conv: both the exact convolution)."""
    from surfh_tpu_torch import pipeline

    assert not hasattr(pipeline, "ALLBAND_RANK_RTOL")
    kw = dict(npix=31, bands=["1a", "1b"], n_pointings=2, n_tpl=2, lambda_subsample=4)
    monkeypatch.setenv("SURFH_CACHE_DIR", str(tmp_path))
    js = jflagship.make_allband_setup(**kw)
    ps = flagship.make_allband_setup(device="cpu", **kw)
    common = ("alpha_axis", "beta_axis", "wavelength_axis", "instrs", "step_degree", "pointings")
    jm = JaxSpectro(js["sotf"], js["templates"], *(js[k] for k in common), dtype=jnp.float64,
                    window_local=True)
    built = {}
    real = pipeline.SpectroSigRLSCT

    def spy(*a, **k):
        built.update(args=a, kwargs=k)
        raise StopIteration

    monkeypatch.setattr(pipeline, "SpectroSigRLSCT", spy)
    with pytest.raises(StopIteration):
        pipeline.run_allband_simulated(window_local=True, device="cpu", n_templates=2,
                                       **{k: v for k, v in kw.items() if k != "n_tpl"})
    assert built["args"][0] is not None and built["kwargs"]["window_local"] is True
    assert set(built["kwargs"]) == {"dtype", "window_local", "channels"}
    # the reference's sotf (the two setups' complex64 OTFs agree to their rounding only)
    pm = real(js["sotf"], ps["templates"], *(ps[k] for k in common), dtype=np.float64,
              window_local=True).to("cpu", torch.float64)
    assert pm.conv_impl == "matmul" and all("sotf_w" in t for t in pm.host_tables()["chan"])
    x = np.array(js["maps"])
    y = np.random.default_rng(7).standard_normal(jm.oshape)
    tables = jm.device_tables()
    assert rel(pm.forward(torch.as_tensor(x)), jax.jit(jm._forward_fn_tabled)(x, tables)) <= TOL
    assert rel(pm.adjoint(torch.as_tensor(y)), jax.jit(jm._adjoint_fn_tabled)(y, tables)) <= TOL


def test_flagship_model_takes_the_reference_conv_choices(monkeypatch):
    """`make_flagship_model`'s conv keywords and environment overrides, at a
    toy size: the rank model by default, the dense stamps under
    SURFH_CONV_RANK_RTOL=0, the OTF-window tables under SURFH_PSF_STAMPS=0."""
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    s = flagship.make_flagship_setup(npix=31, bands=["1a"], n_pointings=1, lambda_subsample=30,
                                     build_sotf=True, device="cpu")
    m, _ = flagship.make_flagship_model(s, dtype=np.float64)
    assert m.conv_impl == "matmul" and m.conv_freq_rtol == 1e-6 and m.conv_rank_rtol == 1e-7
    monkeypatch.setenv("SURFH_CONV_RANK_RTOL", "0")
    m, _ = flagship.make_flagship_model(s, dtype=np.float64)
    assert m.conv_rank_rtol == 0.0 and "psf" in m.host_tables()["chan"][0]
    monkeypatch.setenv("SURFH_PSF_STAMPS", "0")
    monkeypatch.setenv("SURFH_CONV_FREQ_RTOL", "0")
    m, _ = flagship.make_flagship_model(s, dtype=np.float64)
    assert m.psf_stack is None and "sotf_w" in m.host_tables()["chan"][0]
    assert m.conv_supports[0]["ka_max"] is None
    with pytest.raises(ValueError, match="build_sotf=True"):
        flagship.make_flagship_model(dict(s, sotf=None), dtype=np.float64)
    monkeypatch.setenv("SURFH_CONV_PRECISION", "high")
    with pytest.raises(NotImplementedError, match="Do not port"):
        flagship.make_flagship_model(s, dtype=np.float64)


@pytest.mark.parametrize("rank_rtol", [0.0, 1e-7])
def test_worker_processes_build_the_same_tables(monkeypatch, rank_rtol):
    """`workers` > 1 (new channels, or the given ones: only the stamp tables
    go to the processes) builds the serial build's tables bit for bit."""
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    serial = _stamp_model(conv_rank_rtol=rank_rtol)
    pooled = _stamp_model(conv_rank_rtol=rank_rtol, workers=2)
    given = _stamp_model(conv_rank_rtol=rank_rtol, workers=2, channels=serial.channels)
    for m in (pooled, given):
        _assert_tree_equal(m.host_tables(), serial.host_tables())
        assert m.conv_supports == serial.conv_supports
    assert given.channels[1] is serial.channels[1]
