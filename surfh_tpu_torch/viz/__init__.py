"""Visualization: λ-slider cube browser, cube comparison, slice mosaics,
abundance-map grids.

Reference: surfh/Vizualisation/cube_vizualisation.py:5-213 and
slices_vizualisation.py:7-97.  All functions are matplotlib-based and accept
an optional ``show`` flag so they compose into scripts and headless tests.
The port's own copy of `surfh_tpu/viz` (the same code): matplotlib is
imported only inside `_plt`, when a function draws, so nothing else of the
port needs it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    import matplotlib.pyplot as plt

    return plt


def plot_cube(cube, wavelength_cube, show: bool = True):
    """Interactive λ-slider browser of a hyperspectral cube
    (reference plot_cube, cube_vizualisation.py:5-63)."""
    plt = _plt()
    from matplotlib.widgets import Slider

    cube = np.asarray(cube)
    fig, ax = plt.subplots()
    plt.subplots_adjust(bottom=0.2)
    idx0 = cube.shape[0] // 2
    im = ax.imshow(cube[idx0], origin="lower")
    ax.set_title(f"λ = {wavelength_cube[idx0]:.4f} µm")
    ax_slider = plt.axes([0.2, 0.05, 0.6, 0.04])
    slider = Slider(ax_slider, "λ index", 0, cube.shape[0] - 1, valinit=idx0, valstep=1)

    def update(val):
        i = int(slider.val)
        im.set_data(cube[i])
        im.autoscale()
        ax.set_title(f"λ = {wavelength_cube[i]:.4f} µm")
        fig.canvas.draw_idle()

    slider.on_changed(update)
    if show:
        plt.show()
    return fig, slider


def plot_two_cubes(cube_a, wavel_a, cube_b, wavel_b, show: bool = True):
    """Side-by-side λ-slider comparison of two cubes
    (reference plot_two_cubes, cube_vizualisation.py:66-143)."""
    plt = _plt()
    from matplotlib.widgets import Slider

    cube_a, cube_b = np.asarray(cube_a), np.asarray(cube_b)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 5))
    plt.subplots_adjust(bottom=0.2)
    i0 = cube_a.shape[0] // 2
    im1 = ax1.imshow(cube_a[i0], origin="lower")
    j0 = int(np.argmin(np.abs(np.asarray(wavel_b) - wavel_a[i0])))
    im2 = ax2.imshow(cube_b[j0], origin="lower")
    ax_slider = plt.axes([0.2, 0.05, 0.6, 0.04])
    slider = Slider(ax_slider, "λ index", 0, cube_a.shape[0] - 1, valinit=i0, valstep=1)

    def update(val):
        i = int(slider.val)
        im1.set_data(cube_a[i])
        im1.autoscale()
        j = int(np.argmin(np.abs(np.asarray(wavel_b) - wavel_a[i])))
        im2.set_data(cube_b[j])
        im2.autoscale()
        fig.suptitle(f"λ = {wavel_a[i]:.4f} µm")
        fig.canvas.draw_idle()

    slider.on_changed(update)
    if show:
        plt.show()
    return fig, slider


def plot_concatenated_cubes(cubes_list, wavelength_cubes_list, show: bool = True):
    """Browse several cubes stitched along λ with one slider
    (reference cube_vizualisation.py:146-200)."""
    order = np.argsort([w[0] for w in wavelength_cubes_list])
    wavel = np.concatenate([np.asarray(wavelength_cubes_list[i]) for i in order])
    shapes = {tuple(np.shape(cubes_list[i])[1:]) for i in order}
    if len(shapes) != 1:
        raise ValueError("cubes must share spatial shape to concatenate")
    cube = np.concatenate([np.asarray(cubes_list[i]) for i in order], axis=0)
    return plot_cube(cube, wavel, show=show)


def plot_maps(estimated_maps, show: bool = True):
    """Grid of abundance maps (reference plot_maps, cube_vizualisation.py:203)."""
    plt = _plt()
    maps = np.asarray(estimated_maps)
    n = maps.shape[0]
    ncols = min(n, 3)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 4 * nrows), squeeze=False)
    for k in range(nrows * ncols):
        ax = axes[k // ncols][k % ncols]
        if k < n:
            h = ax.imshow(maps[k], origin="lower")
            fig.colorbar(h, ax=ax)
            ax.set_title(f"map {k}")
        else:
            ax.axis("off")
    if show:
        plt.show()
    return fig


def visualize_corrected_slices(data_shape, corrected_data, show: bool = True):
    """Mosaic of corrected per-slit (λ, α) images
    (reference slices_vizualisation.py:7-40)."""
    plt = _plt()
    corrected = np.asarray(corrected_data).reshape(data_shape)
    n_slit = data_shape[0]
    ncols = min(n_slit, 7)
    nrows = (n_slit + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(2 * ncols, 3 * nrows), squeeze=False)
    for s in range(nrows * ncols):
        ax = axes[s // ncols][s % ncols]
        if s < n_slit:
            ax.imshow(corrected[s], aspect="auto", origin="lower")
            ax.set_title(f"slit {s}", fontsize=8)
        ax.axis("off")
    if show:
        plt.show()
    return fig


def plot_flux_comparison(wavel, mean_flux_fusion, mean_flux_real, show: bool = True):
    """Fused-vs-pipeline mean-flux curves plus their relative difference
    (reference scripts/plot_spectra.py:14-22 and the comparison plot of
    compare_mean_flux_fusion_vs_real_data.py:77-79)."""
    plt = _plt()
    wavel = np.asarray(wavel)
    fusion = np.asarray(mean_flux_fusion)
    real = np.asarray(mean_flux_real)
    fig, (ax0, ax1) = plt.subplots(2, 1, sharex=True, figsize=(8, 6))
    ax0.plot(wavel, fusion, label="Fusion", linewidth=2)
    ax0.plot(wavel, real, label="Pipeline", linewidth=2)
    ax0.legend()
    ax0.set_ylabel("mean flux")
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(fusion != 0, (fusion - real) / fusion, 0.0)
    ax1.plot(wavel, rel, linewidth=2)
    ax1.set_ylabel("(fusion − pipeline) / fusion")
    ax1.set_xlabel("λ (µm)")
    if show:
        plt.show()
    return fig


def visualize_projected_slices(slices, wavels: Optional[Sequence[float]] = None, show: bool = True):
    """One image per slice stack at chosen wavelengths
    (reference slices_vizualisation.py:50-97)."""
    plt = _plt()
    slices = np.asarray(slices)
    fig, ax = plt.subplots()
    ax.imshow(slices if slices.ndim == 2 else slices[0], aspect="auto", origin="lower")
    if wavels is not None:
        ax.set_title(f"λ = {wavels}")
    if show:
        plt.show()
    return fig
