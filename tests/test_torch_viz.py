"""surfh_tpu_torch's plotting helpers (`viz`), headless (Agg), on the
cases of tests/test_viz.py: each draws what the JAX package's draws (the
same images in its axes)."""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from surfh_tpu import viz as jax_viz  # noqa: E402
from surfh_tpu_torch import viz  # noqa: E402


def images(fig):
    return [np.asarray(im.get_array()) for ax in fig.axes for im in ax.get_images()]


def same_figure(a, b):
    ia, ib = images(a), images(b)
    assert len(ia) == len(ib)
    for x, y in zip(ia, ib):
        np.testing.assert_array_equal(x, y)


RNG = np.random.default_rng(0)
CUBE_A, CUBE_B = RNG.random((5, 8, 8)), RNG.random((6, 8, 8))
WL_A, WL_B = np.linspace(5, 6, 5), np.linspace(5, 6, 6)
CALLS = {
    "plot_cube": lambda m: m.plot_cube(CUBE_A, WL_A, show=False),
    "plot_two_cubes": lambda m: m.plot_two_cubes(CUBE_A, WL_A, CUBE_B, WL_B, show=False),
    "plot_concatenated_cubes": lambda m: m.plot_concatenated_cubes(
        [CUBE_B, CUBE_A], [WL_B + 1, WL_A], show=False),
    "plot_maps": lambda m: m.plot_maps(RNG.random((4, 8, 8)), show=False),
    "visualize_corrected_slices": lambda m: m.visualize_corrected_slices(
        (5, 10, 6), np.arange(300.0), show=False),
    "plot_flux_comparison": lambda m: m.plot_flux_comparison(
        WL_B, np.arange(1.0, 7.0), np.arange(6.0), show=False),
    "visualize_projected_slices": lambda m: m.visualize_projected_slices(
        CUBE_B, wavels=[5.5], show=False),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_plot_matches_reference(name):
    import matplotlib.pyplot as plt

    state = RNG.bit_generator.state
    got = CALLS[name](viz)
    RNG.bit_generator.state = state
    want = CALLS[name](jax_viz)
    fig_g = got[0] if isinstance(got, tuple) else got
    fig_w = want[0] if isinstance(want, tuple) else want
    same_figure(fig_g, fig_w)
    if isinstance(got, tuple):  # the λ slider moves the images as the reference's
        got[1].set_val(2)
        want[1].set_val(2)
        same_figure(fig_g, fig_w)
    plt.close("all")


def test_concatenate_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="spatial shape"):
        viz.plot_concatenated_cubes([CUBE_A, RNG.random((2, 4, 4))], [WL_A, WL_A[:2]], show=False)


def test_matplotlib_is_imported_lazily():
    import subprocess
    import sys

    code = ("import sys, surfh_tpu_torch.viz, surfh_tpu_torch.cli, surfh_tpu_torch.parallel\n"
            "assert 'matplotlib' not in sys.modules\n")
    assert subprocess.run([sys.executable, "-c", code], capture_output=True).returncode == 0
