"""Real-data fusion pipeline: corrected-slice FITS directory → reconstruction.

Counterpart of `surfh_tpu/pipeline.py` (reference scripts/main_fusion.py:
load_data :30-62, create_instruments :103-134, create_model :136-157,
reconstruction :162-207), with the W-plane (materialized-OTF) model of the
port on a torch device.  The OTF is built on that device
(`fft.ir2fr_device`), not on the host.  `device` None means the card
(raise without one); pass "cpu" for the host.

Expected directory layout:

    fusion_dir/
      Templates/templates.npy        # [n_tpl, Nλ] (NMF output)
      Templates/wavel_axis.npy       # [Nλ] global cube λ axis
      PSF/psf.npy                    # [Nλ, h, w] monochromatic PSFs
      Filtered_slices/*.fits         # corrected+filtered slices, one file
                                     # per (band, pointing); headers carry
                                     # PA_V3 / TARG_RA / TARG_DEC / BAND

Slice files store [Nλ_det, n_slit·Nα_det].  The band's detector λ table is
looked up through this module's `get_mrs_wavelength`, so one assignment
to it shrinks every stage.  `run_allband_simulated` is BASELINE config 5
(all bands, NMF templates learned on the device) on simulated data.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .core.fft import ir2fr_device
from .core.precision import pick_device
from .instrument.geometry import FOV, Coord, CoordList
from .instrument.ifu import IFU
from .instrument.realmiri import _CHANNEL_SPECS, GRATING_RES
from .instrument.spectral import SpectralBlur
from .instrument.wavelength_mrs import get_mrs_wavelength
from .models.spectro import SpectroSigRLSCT, _np_dtype
from .preprocessing.fits_io import fits_open

STEP_ARCSEC = 0.025


def _dtypes(dtype):
    """(NumPy table dtype, torch dtype, torch complex dtype); None is float32."""
    npdtype = _np_dtype(np.float32 if dtype is None else dtype)
    tdtype = torch.float64 if npdtype == np.float64 else torch.float32
    ctype = torch.complex128 if npdtype == np.float64 else torch.complex64
    return npdtype, tdtype, ctype


def crop_psf_stack(spsf: np.ndarray, npix: int) -> np.ndarray:
    """Center-crop a monochromatic PSF stack [Nλ, h, w] to the sky grid,
    with the reference's centering convention (window start idx-(N//2) for
    odd N, idx-(N/2-1) for even, clamped to the stack)."""
    spsf = np.asarray(spsf)
    out = spsf
    for ax in (1, 2):
        size = out.shape[ax]
        if size <= npix:
            continue
        idx = size // 2
        stepidx = npix // 2 if npix % 2 else npix // 2 - 1
        start = min(max(idx - stepidx, 0), size - npix)
        sl = [slice(None)] * out.ndim
        sl[ax] = slice(start, start + npix)
        out = out[tuple(sl)]
    return out


def load_corrected_data(slices_dir: str, bands: Sequence[str]) -> Dict:
    """Load per-band corrected slices (reference load_data, main_fusion.py:30-62)."""
    out = {"data": {b: [] for b in bands}, "target": {b: [] for b in bands}, "rotation": {b: 0.0 for b in bands}}
    for fname in sorted(os.listdir(slices_dir)):
        if not fname.endswith(".fits"):
            continue
        for band in bands:
            if band not in fname.lower():
                continue
            hdus = fits_open(os.path.join(slices_dir, fname))
            hdr = hdus[0].header
            data = np.asarray(hdus[0].data)
            n_lam = len(get_mrs_wavelength(band))
            n_slit = _CHANNEL_SPECS[int(band[0])][0]
            ndata = data.reshape(n_lam, n_slit, -1).transpose(1, 0, 2)
            out["data"][band].append(ndata)
            out["target"][band].append((float(hdr["TARG_RA"]), float(hdr["TARG_DEC"])))
            out["rotation"][band] = float(hdr["PA_V3"])
    return out


def create_instruments(data_dict: Dict, bands: Sequence[str]) -> Dict[str, IFU]:
    """Degree-unit IFUs with the observation position angle
    (reference create_instruments, main_fusion.py:103-134)."""
    instruments = {}
    for band in bands:
        chan = int(band[0])
        n_slit, pix, aw, bw, _ = _CHANNEL_SPECS[chan]
        res = GRATING_RES[(chan - 1) * 3 + "abc".index(band[1])]
        instruments[band] = IFU(
            fov=FOV(aw / 3600, bw / 3600, origin=Coord(0, 0), angle=-data_dict["rotation"][band]),
            det_pix_size=pix,
            n_slit=n_slit,
            w_blur=SpectralBlur(res),
            pce=None,
            wavel_axis=get_mrs_wavelength(band),
            name=band.upper(),
        )
    return instruments


def create_model(
    sotf,
    templates,
    alpha_axis,
    beta_axis,
    wavel_axis,
    instruments: Dict[str, IFU],
    step_degree: float,
    data_dict: Dict,
    ref_band: Optional[str] = None,
    dtype=None,
    device=None,
) -> SpectroSigRLSCT:
    """The W-plane model anchored at the observed pointings (reference
    create_model, main_fusion.py:136-157), its tables on `device`.

    `dtype` (NumPy or torch; None: float32, as the reference) is the type of
    the host tables and of the device tensors; `sotf` is a host array or a
    tensor (e.g. from `fft.ir2fr_device`)."""
    device = pick_device(device)
    npdtype, tdtype, _ = _dtypes(dtype)
    bands = list(instruments.keys())
    if ref_band is None:
        ref_band = bands[0]
    main = Coord(0, 0)
    pointings = []
    for band in bands:
        pts = [main + Coord(ra, dec) for ra, dec in data_dict["target"][band]]
        pointings.append(CoordList(pts).pix(step_degree))
    ref_idx = min(2, len(data_dict["target"][ref_band]) - 1)
    ra0, dec0 = data_dict["target"][ref_band][ref_idx]
    model = SpectroSigRLSCT(
        sotf=sotf,
        templates=templates,
        alpha_axis=np.asarray(alpha_axis) + ra0,
        beta_axis=np.asarray(beta_axis) + dec0,
        wavelength_axis=np.asarray(wavel_axis),
        instrs=[instruments[b] for b in bands],
        step_degree=step_degree,
        pointings=pointings,
        dtype=npdtype,
    )
    return model.to(device, tdtype)


def assemble_data_vector(model, data_dict: Dict, bands: Sequence[str]) -> np.ndarray:
    """Per-band [P, S, λ, α] blocks → the model's flat data layout."""
    blocks = []
    for c, band in enumerate(bands):
        stack = np.stack(data_dict["data"][band])  # [P, S, λ, α]
        want = model.instrs_oshape[c]
        if stack.shape != want:
            raise ValueError(f"band {band}: data shape {stack.shape} != model {want}")
        blocks.append(np.nan_to_num(stack).ravel())
    return np.concatenate(blocks)


def _check_method(method: str) -> None:
    if method not in ("lcg", "mmmg"):
        raise ValueError(f"unknown method {method!r}: lcg or mmmg")


def _sync(device: torch.device) -> None:
    """Wait for the card's queue, so a host clock reads the work's end."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_real_fusion(
    fusion_dir: str,
    bands: Sequence[str],
    npix: int = 501,
    mu: float = 5e3,
    niter: int = 50,
    method: str = "lcg",
    scale_data: bool = False,
    output_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    step_arcsec: float = STEP_ARCSEC,
    dtype=None,
    device=None,
):
    """End-to-end real-data fusion (the reference's flagship entry point):
    load, build, normalize the flux (`scale_data`), run a checkpointed
    `lcg` (resuming from ``output_dir/solver_state.npz`` when it exists).
    Returns (SolverResult, model); the result's `x` is a tensor on `device`.

    `step_arcsec` is the super-resolution grid step (the reference hardcodes
    0.025″, main_fusion.py:74); `dtype` as in :func:`create_model`."""
    from .solvers.checkpoint import run_checkpointed
    from .solvers.criterion import QuadCriterion_MRS

    device = pick_device(device)
    _check_method(method)
    _, _, ctype = _dtypes(dtype)
    step_degree = step_arcsec / 3600.0
    tpl_dir = os.path.join(fusion_dir, "Templates")
    templates = np.load(os.path.join(tpl_dir, "templates.npy"))
    wavel_axis = np.load(os.path.join(tpl_dir, "wavel_axis.npy"))
    spsf = crop_psf_stack(np.load(os.path.join(fusion_dir, "PSF", "psf.npy")), npix)

    alpha_axis = np.arange(npix) * step_degree
    alpha_axis -= np.mean(alpha_axis)
    beta_axis = alpha_axis.copy()
    sotf = ir2fr_device(spsf, (npix, npix), device, dtype=ctype)

    data_dict = load_corrected_data(os.path.join(fusion_dir, "Filtered_slices"), bands)
    instruments = create_instruments(data_dict, bands)
    model = create_model(
        sotf, templates, alpha_axis, beta_axis, wavel_axis, instruments,
        step_degree, data_dict, dtype=dtype, device=device,
    )
    y = assemble_data_vector(model, data_dict, bands)
    if scale_data:
        y = model.real_data_janskySR_to_jansky(y)

    crit = QuadCriterion_MRS(1.0, y, model, mu, printing=True)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    ck = os.path.join(output_dir, "solver_state.npz") if output_dir else None
    res = run_checkpointed(
        crit, method=method, niter=niter,
        checkpoint_path=ck, checkpoint_every=checkpoint_every,
    )
    if output_dir:
        np.save(os.path.join(output_dir, "res_x.npy"), res.x.cpu().numpy())
        np.save(os.path.join(output_dir, "res_cube.npy"), model.mapsToCube(res.x).cpu().numpy())
        np.save(os.path.join(output_dir, "criterion.npy"), res.grad_norm)
    return res, model


def run_rehearsal(
    work_dir: str,
    band: str = "4a",
    n_pointings: int = 2,
    npix: int = 61,
    step_arcsec: float = 0.1,
    lambda_subsample: int = 4,
    n_tpl: int = 2,
    mu: float = 10.0,
    niter: int = 30,
    method: str = "lcg",
    n_rows: Optional[int] = None,
    noise_rms: float = 0.0,
    targ_ra: float = 83.83,
    targ_dec: float = -5.42,
    pa_v3: float = 0.0,
    device=None,
) -> Dict:
    """The production real-data flow as one chained run:

      synthetic stage-2 cal.fits → distortion correction (Shepard, slit
      reorder) → median λ-filter → corrected-slice FITS → fusion →
      flux comparison

    (reference scripts/correction_mrs_data.py:92-199 →
    filter_corrected_mrs_data.py:34 → main_fusion.py:215-273 →
    compare_mean_flux_fusion_vs_real_data.py).  The stage-2 inputs and
    their WCS are synthesized (`simulation.stage2`); every stage downstream
    of the loader is the production code path, the Shepard regrid and the
    fusion on `device` (None: the card).

    Returns the reference's report: per-stage timings, the fusion residual
    and the fused-vs-data mean-flux comparison."""
    from .instrument import miri
    from .instrument.geometry import get_srf
    from .preprocessing.correction_driver import correct_file, corrected_to_fits
    from .preprocessing.distortion import median_filter_slices
    from .simulation.stage2 import stage2_wcs_loader, write_synthetic_stage2
    from .utils.psf import gaussian_psf

    device = pick_device(device)
    _check_method(method)
    report: Dict = {"band": band, "n_pointings": n_pointings, "npix": npix,
                    "targ_ra": targ_ra, "targ_dec": targ_dec, "pa_v3": pa_v3}
    lam_table = get_mrs_wavelength(band)
    # cube λ axis: the band table subsampled, EXTENDED by the spectral-blur
    # margin on both ends (a lone band needs the margin explicitly or the
    # wpsf support truncates at the table edges)
    dstep = float(np.median(np.diff(lam_table))) * lambda_subsample
    margin = np.arange(1, int(np.ceil(0.1 / dstep)) + 1) * dstep
    wavel_axis = np.concatenate([
        lam_table[0] - margin[::-1],
        np.asarray(lam_table[::lambda_subsample], np.float64),
        lam_table[-1] + margin,
    ])

    # 1. synthetic stage-2 observations: one file per dither pointing
    t0 = time.perf_counter()
    raw_dir = os.path.join(work_dir, "raw")
    dith = np.asarray(miri.dithering)[:n_pointings] / 3600.0
    # α sampling density of the detector strips ≈ the corrected grid's
    # per-slit α count, so the Shepard regrid has a sample within its
    # pixel cutoff of every output cell (like the real detector)
    _n_slit, det_pix, aw, _bw, _rot = _CHANNEL_SPECS[int(band[0])]
    srf = get_srf([det_pix], step_arcsec)[0]
    strip_w = int(np.ceil(aw / step_arcsec / srf)) + 1
    raw_files = []
    for p in range(n_pointings):
        path = os.path.join(raw_dir, f"obs1_ch{band}_dither{p + 1}_cal.fits")
        write_synthetic_stage2(
            path, band,
            targ_ra + float(dith[p][0]), targ_dec + float(dith[p][1]),
            pa_v3=pa_v3, n_rows=n_rows, strip_w=strip_w,
            scene_ra=targ_ra, scene_dec=targ_dec,  # fixed sky, moving FOV
            noise_rms=noise_rms, seed=p,
        )
        raw_files.append(path)
    report["t_stage2_s"] = round(time.perf_counter() - t0, 2)
    report["n_raw_files"] = len(raw_files)

    # 2+3. distortion correction + median λ-filter → Filtered_slices/
    t0 = time.perf_counter()
    filt_dir = os.path.join(work_dir, "Filtered_slices")
    os.makedirs(filt_dir, exist_ok=True)
    for p, path in enumerate(raw_files):
        corrected, ifu, ra, dec = correct_file(
            path, f"ch{band}", npix, wavel_axis, mode=0,
            wcs_loader=stage2_wcs_loader, step_arcsec=step_arcsec, device=device,
        )
        filtered = median_filter_slices(corrected, size=11)
        corrected_to_fits(
            os.path.join(filt_dir, f"{band}_dither{p + 1}_corrected.fits"),
            filtered, ifu, ra, dec,
        )
    report["t_correct_s"] = round(time.perf_counter() - t0, 2)

    # 4. fusion assets: templates learned from the corrected data (mean data
    # spectrum + a flat continuum span the LMM's spectral space); λ axis; PSF
    tpl_dir = os.path.join(work_dir, "Templates")
    os.makedirs(tpl_dir, exist_ok=True)
    dd0 = load_corrected_data(filt_dir, [band])
    arr = np.stack(dd0["data"][band])  # [P, S, λ_det, α]
    with np.errstate(invalid="ignore"):
        spec_det = np.nanmean(np.where(arr > 0, arr, np.nan), axis=(0, 1, 3))
    spec_det = np.nan_to_num(spec_det, nan=float(np.nanmedian(spec_det)))
    spec = np.interp(wavel_axis, np.asarray(lam_table, np.float64), spec_det)
    spec = spec / max(spec.mean(), 1e-30)
    templates = np.stack([spec] + [np.ones_like(spec)] * max(n_tpl - 1, 1))[:n_tpl]
    if n_tpl > 2:
        lam01 = (wavel_axis - wavel_axis[0]) / max(wavel_axis[-1] - wavel_axis[0], 1e-9)
        for m in range(2, n_tpl):
            templates[m] = 0.5 + lam01 ** m
    np.save(os.path.join(tpl_dir, "templates.npy"), templates)
    np.save(os.path.join(tpl_dir, "wavel_axis.npy"), wavel_axis)
    psf_dir = os.path.join(work_dir, "PSF")
    os.makedirs(psf_dir, exist_ok=True)
    np.save(os.path.join(psf_dir, "psf.npy"), gaussian_psf(wavel_axis, step_arcsec))

    # 5. fusion (the production entry, unmodified)
    t0 = time.perf_counter()
    out_dir = os.path.join(work_dir, "out")
    res, model = run_real_fusion(
        work_dir, [band], npix=npix, mu=mu, niter=niter, method=method,
        scale_data=True,  # Jy/sr → Jy: slit β-weight sum × SRF (ref :225-239)
        output_dir=out_dir, step_arcsec=step_arcsec, device=device,
    )
    report["t_fusion_s"] = round(time.perf_counter() - t0, 2)

    data_dict = load_corrected_data(filt_dir, [band])
    y = model.real_data_janskySR_to_jansky(assemble_data_vector(model, data_dict, [band]))
    q = rehearsal_quality(model, res.x, y)
    report["residual_rel"] = q["residual_rel"]
    report["n_iterations"] = int(len(res.grad_norm))
    for k in ("flux_ratio_median", "flux_shape_corr", "flux_points"):
        report[k] = q[k]
    np.savez(os.path.join(out_dir, "flux_compare.npz"),
             mean_flux_fusion=q["flux_fused"], mean_flux_real=q["flux_data"])
    report["output_dir"] = out_dir
    return report


def rehearsal_quality(model, x, y: np.ndarray, flux_data: Optional[np.ndarray] = None) -> Dict:
    """The rehearsal's quality numbers of the maps `x` against the
    flux-normalized data `y` of band 0: residual_rel over the samples Shepard
    filled, and the fused cube's per-λ mean flux against the data
    re-projected to the cube (`Channel.sliceToCube`; pass its curve as
    `flux_data` to reuse it).  The dirac re-projection carries other units
    than the model cube, so the curves are compared in shape (unit-mean
    normalized): flux_ratio_median, flux_shape_corr, flux_points."""
    from .utils import metrics

    yhat = model.forward(x).cpu().numpy()
    mask = np.abs(y) > 0  # Shepard leaves zeros where no sample is in range
    out = {"residual_rel": float(np.linalg.norm((yhat - y)[mask]) / np.linalg.norm(y[mask]))}
    if flux_data is None:
        flux_data = metrics.nonzero_mean_per_slice(model.channels[0].sliceToCube(model.split(y)[0]))
    flux_fused = metrics.nonzero_mean_per_slice(model.mapsToCube(x).cpu().numpy())
    ok = (flux_data > 0) & (flux_fused > 0)
    ff = flux_fused[ok] / flux_fused[ok].mean()
    fd = flux_data[ok] / flux_data[ok].mean()
    out.update(flux_ratio_median=float(np.median(ff / fd)), flux_shape_corr=float(np.corrcoef(ff, fd)[0, 1]),
               flux_points=int(ok.sum()), flux_fused=flux_fused, flux_data=flux_data)
    return out


def coadd_cube(channels, blocks, cube_shape, device) -> torch.Tensor:
    """The dirty hypercube [L, Na, Nb] (float64, on `device`): each band's
    `sliceToCube` of its data block added in, divided by the number of
    bands whose λ window holds each plane (at least 1).  A band's
    re-projection is zero outside its window, so only the window is
    computed (`Channel.sliceToWindow`, on `device`) and added."""
    cube = torch.zeros(cube_shape, dtype=torch.float64, device=device)
    cover = np.zeros(cube_shape[0])
    for chan, block in zip(channels, blocks):
        cube[chan.wslice] += chan.sliceToWindow(block, device)
        cover[chan.wslice] += 1.0
    cube /= torch.as_tensor(np.maximum(cover, 1.0), device=device)[:, None, None]
    return cube


def bright_mask(cube: torch.Tensor, q: float) -> np.ndarray:
    """Pixels whose λ-summed flux is above its `q` quantile (host boolean
    [Na, Nb]).  The planes are added one after another, as NumPy's
    ``sum(axis=0)`` adds them, so the same cube gives the reference's mask
    bit for bit: pixels tie with the quantile, and another summation order
    flips them."""
    bright = cube[0].clone()
    for plane in cube[1:]:
        bright += plane
    bright = bright.cpu().numpy()
    return bright > np.quantile(bright, q)


def unit_rows(templates: np.ndarray) -> np.ndarray:
    """Template rows scaled to unit L2 (in their dtype).  The LMM is
    scale-invariant between templates and maps, but unnormalized NMF rows
    (O(10-100) on bright cubes) square into HᵗH and push float32 CG past
    overflow at production scale."""
    tnorm = np.linalg.norm(templates, axis=1, keepdims=True)
    return np.ascontiguousarray(templates / np.maximum(tnorm, 1e-30))


def run_allband_simulated(
    npix: int = 61,
    bands: Optional[Sequence[str]] = None,
    n_pointings: int = 4,
    n_templates: int = 4,
    mu: float = 5e3,
    niter: int = 50,
    method: str = "lcg",
    nmf_iter: int = 300,
    mask_threshold_q: float = 0.25,
    output_dir: Optional[str] = None,
    window_local: bool = False,
    lambda_subsample: int = 1,
    seed: int = 19940407,
    device=None,
) -> Dict:
    """BASELINE config 5 as one pipeline (reference
    `surfh_tpu/pipeline.py::run_allband_simulated`): all-band data →
    NMF templates learned on the device → all-band LMM fusion → metrics.

      1. simulate detector data through the all-band operator (the OTF
         built on `device`, the dense blur);
      2. co-add each band's `sliceToCube` into a dirty hypercube
         (`coadd_cube`, float64 on `device`);
      3. learn `n_templates` NMF templates from the pixels brighter than the
         `mask_threshold_q` quantile (`bright_mask`,
         `learning.learn_templates_nmf`);
      4. normalize the template rows to unit L2 (`unit_rows`), rebuild the
         operator over the same channels with them and solve with `method`;
      5. report per-stage timings and the cube-space metrics.

    ``window_local=True`` builds the window-local model over the same OTF
    instead, as the reference does: the OTF-window tables (each band's
    λ-window of the sotf, a view of it on the device) and the dense matmul
    conv (``conv_impl="auto"`` resolves to "matmul": the card plays the
    TPU's part).  The first model's tables leave the device once the truth
    cube and the data are taken.
    Writes allband_templates.npy, allband_x.npy and allband_cube.npy to
    `output_dir`.  `device` None is the card (raise without one)."""
    from .learning.decomposition import learn_templates_nmf
    from .simulation.flagship import make_allband_setup
    from .solvers.criterion import QuadCriterion_MRS
    from .utils import metrics

    device = pick_device(device)
    _check_method(method)
    timings = {}
    t0 = time.perf_counter()
    setup = make_allband_setup(
        npix=npix, bands=list(bands) if bands else None, n_pointings=n_pointings,
        n_tpl=n_templates, lambda_subsample=lambda_subsample, seed=seed,
        build_sotf=True, device=device,
    )

    def _build(templates, channels=None):
        common = (templates, setup["alpha_axis"], setup["beta_axis"], setup["wavelength_axis"],
                  setup["instrs"], setup["step_degree"], setup["pointings"])
        m = SpectroSigRLSCT(setup["sotf"], *common, dtype=np.float32, window_local=window_local,
                            channels=channels)
        return m.to(device, torch.float32)

    model = _build(setup["templates"])
    _sync(device)
    timings["build_s"] = time.perf_counter() - t0

    truth_maps = torch.as_tensor(np.asarray(setup["maps"], np.float32), device=device)
    truth_cube = model.mapsToCube(truth_maps)
    t0 = time.perf_counter()
    y = model.forward(truth_maps)
    _sync(device)
    timings["simulate_s"] = time.perf_counter() - t0
    channels, cube_shape = model.channels, model.cube_shape
    blocks = model.split(y)
    del model  # its device tables; the OTF stays for the second model

    # 2. dirty hypercube: coverage-normalized co-add of the detector data
    t0 = time.perf_counter()
    cube0 = coadd_cube(channels, blocks, cube_shape, device)
    _sync(device)
    timings["coadd_s"] = time.perf_counter() - t0

    # 3. NMF templates from the bright region of the dirty cube
    t0 = time.perf_counter()
    mask = bright_mask(cube0, mask_threshold_q)
    templates, _maps0, nmf_err = learn_templates_nmf(
        cube0.clamp_min_(0.0), n_templates, mask=mask, n_iter=nmf_iter, seed=seed,
    )
    del cube0, _maps0
    templates = templates.cpu().numpy()
    timings["nmf_s"] = time.perf_counter() - t0

    # 4. fuse with the learned, row-normalized templates
    templates = unit_rows(templates)
    model2 = _build(templates, channels=channels)
    t0 = time.perf_counter()
    crit = QuadCriterion_MRS(1.0, y, model2, mu)
    res = crit.run_method(method, maximum_iterations=niter)
    _sync(device)
    timings["solve_s"] = time.perf_counter() - t0

    res_cube = model2.mapsToCube(res.x).cpu().numpy()
    truth_cube = truth_cube.cpu().numpy()
    report = {
        "bands": list(setup["bands"]),
        "n_lambda": int(cube_shape[0]),
        "npix": npix,
        "niter": int(res.n_iter),
        "iters_per_s": res.n_iter / max(timings["solve_s"], 1e-9),
        "nmf_recon_err": float(nmf_err),
        "psnr_cube": metrics.psnr(truth_cube, res_cube),
        "relative_cube_error_pct": metrics.relative_error(truth_cube, res_cube),
        "timings_s": {k: round(v, 3) for k, v in timings.items()},
    }
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        np.save(os.path.join(output_dir, "allband_templates.npy"), templates)
        np.save(os.path.join(output_dir, "allband_x.npy"), res.x.cpu().numpy())
        np.save(os.path.join(output_dir, "allband_cube.npy"), res_cube)
    return report
