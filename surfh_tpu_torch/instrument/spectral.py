"""Spectral response of the MRS gratings (sinc² line-spread function).

Host-side construction of the wpsf tensor [λ_det, λ_sky, β] consumed by the
wblur kernels: `SpectralBlur` (surfh `instru.py:484-572`), including the
margin-normalization trick and the 'dirac' re-projection mode.  The port's
own copy of `surfh_tpu/instrument/spectral.py`: the same code, cache key
and file contents under `SURFH_CACHE_DIR`, whose default here is
``surfh_cache`` in the temporary directory (it follows TMPDIR).
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

# Margin (in input-axis samples) appended on each side purely to normalize the
# PSF in the convolution sense; removed from the returned tensor.
_N_MARGIN = 15

# The sinc² evaluation over [λ_det, λ_in+margins, β] is the most expensive
# model-construction stage (tens of millions of f64 sinc calls per flagship
# band on a 1-vCPU host) and is a pure function of its inputs — cache it on
# disk (best-effort, like the flagship sotf cache) and in memory.
_PSF_MEM_CACHE: dict = {}


def _psfs_cache_key(g, out_axis, beta, wavelength, scale, type_) -> str:
    h = hashlib.sha1()
    h.update(np.float64(g).tobytes())
    h.update(np.float64(scale).tobytes())
    h.update(type_.encode())
    for a in (out_axis, beta, wavelength):
        h.update(np.ascontiguousarray(a, np.float64).tobytes())
    return h.hexdigest()[:20]


class SpectralBlur:
    """Grating spectral PSF parameterized by resolution R = λ/Δλ."""

    def __init__(self, grating_resolution: float):
        self.grating_resolution = grating_resolution
        self._n_margin = _N_MARGIN

    @property
    def grating_len(self) -> float:
        """Effective grating length for the given resolution."""
        return 2 * 0.44245 / np.pi * self.grating_resolution

    def psfs(self, out_axis, beta, wavelength, scale: float = 1.0, type: str = "mrs") -> np.ndarray:
        """Normalized discretized spectral PSF, shape [λ_out, λ_in, β].

        Parameters
        ----------
        out_axis: detector wavelength axis (μm).
        beta: within-slit β offsets (arcsec); shifts the line center.
        wavelength: input (sky) wavelength axis (μm).
        scale: μm / arcsec conversion for the β-induced shift.
        type: 'mrs' for the sinc² PSF, 'dirac' for a nearest-sample indicator
              (used to re-project detector data back to a cube).
        """
        key = _psfs_cache_key(
            self.grating_len, out_axis, beta, wavelength, scale, type
        )
        if key in _PSF_MEM_CACHE:
            return _PSF_MEM_CACHE[key]
        cache_dir = os.environ.get("SURFH_CACHE_DIR",
                                   os.path.join(tempfile.gettempdir(), "surfh_cache"))
        cache_path = os.path.join(cache_dir, f"wpsf_{key}.npy")
        if os.path.exists(cache_path):
            out = np.load(cache_path)
            _PSF_MEM_CACHE[key] = out
            return out

        wavelength = np.asarray(wavelength)
        delta_w = float(np.min(np.diff(wavelength)))

        beta = np.asarray(beta).reshape((1, 1, -1))
        out_axis = np.asarray(out_axis).reshape((-1, 1, 1))

        m = self._n_margin
        w_norm = np.concatenate(
            [
                np.linspace(wavelength.min() - m * delta_w, wavelength.min() - delta_w, m - 1),
                wavelength,
                np.linspace(wavelength.max() + delta_w, wavelength.max() + m * delta_w, m - 1),
            ]
        ).reshape((1, -1, 1))

        # sinc² line shape; the prefactor cancels in the normalization but is
        # kept as the trace of the continuous formula.
        g = self.grating_len
        out = (
            np.pi
            / w_norm
            * g
            * np.sinc(np.pi * g * ((out_axis - scale * beta) / w_norm - 1)) ** 2
        )
        out /= np.sum(out, axis=1, keepdims=True)

        if type == "dirac":
            peak = out == np.max(out, axis=1, keepdims=True)
            out = peak.astype(out.dtype)

        out = out[:, m - 1 : -m + 1, :]
        _PSF_MEM_CACHE[key] = out
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = cache_path + f".tmp{os.getpid()}.npy"
            np.save(tmp, out)
            os.replace(tmp, cache_path)
        except OSError:
            pass  # cache is best-effort (read-only or full filesystem)
        return out
