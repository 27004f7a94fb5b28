"""Sky/instrument geometry: coordinates, fields of view, resolution arithmetic.

Host-side (NumPy float64) geometry used once at model construction to derive
the static index/weight tables of the operators.  The port's own copy of
`surfh_tpu/instrument/geometry.py` (same code, so both packages derive the
same tables; the surfh `instru.py` lines cited below are the original's).
"""

from __future__ import annotations

from dataclasses import dataclass
from math import ceil, floor
from typing import List, Sequence, Tuple

import numpy as np


def rotmatrix(degree: float) -> np.ndarray:
    """2×2 rotation matrix for an angle in degrees."""
    theta = np.radians(degree)
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def get_step(det_pix_size_list: Sequence[float], pix_ratio_tol: int = 3) -> float:
    """Common super-resolution step across channels.

    The largest divisor of the smallest detector pixel size such that every
    detector pixel size is (to within `min/pix_ratio_tol`) an integer multiple
    of it.  Reference: instru.py:48-64.
    """
    sizes = np.asarray(det_pix_size_list)
    smallest = float(np.min(sizes))
    num = 1
    while not np.all(sizes % (smallest / num) <= smallest / pix_ratio_tol):
        num += 1
    return smallest / num


def get_srf(det_pix_size_list: Sequence[float], step: float) -> List[int]:
    """Per-channel integer super-resolution factor: det_pix_size // step."""
    return [int(size // step) for size in det_pix_size_list]


@dataclass
class Coord:
    """A point in (α, β) sky coordinates; supports +, −, rotation, grid rounding."""

    alpha: float
    beta: float

    @classmethod
    def from_array(cls, arr) -> "Coord":
        return cls(float(arr[0]), float(arr[1]))

    def __add__(self, other: "Coord") -> "Coord":
        return Coord(self.alpha + other.alpha, self.beta + other.beta)

    def __sub__(self, other: "Coord") -> "Coord":
        return Coord(self.alpha - other.alpha, self.beta - other.beta)

    def rotate(self, degree: float) -> "Coord":
        """Rotate by `degree` (the reference rotates by the *negative* angle
        in `Coord.rotate`, instru.py:128-141 — kept for parity)."""
        vec = rotmatrix(-degree) @ np.array([self.alpha, self.beta])
        return Coord(float(vec[0]), float(vec[1]))

    def pix(self, step: float) -> "Coord":
        """Round both coordinates to the nearest multiple of `step`."""
        return Coord(round(self.alpha / step) * step, round(self.beta / step) * step)

    def as_array(self) -> np.ndarray:
        return np.array([self.alpha, self.beta])


class CoordList(list):
    """A list of `Coord` with bounding-box helpers (instru.py:154-253)."""

    @classmethod
    def from_array(cls, arr) -> "CoordList":
        return cls(Coord.from_array(a) for a in arr)

    @property
    def alpha_min(self):
        return min(c.alpha for c in self)

    @property
    def beta_min(self):
        return min(c.beta for c in self)

    @property
    def alpha_max(self):
        return max(c.alpha for c in self)

    @property
    def beta_max(self):
        return max(c.beta for c in self)

    @property
    def alpha_mean(self):
        return (self.alpha_max + self.alpha_min) / 2

    @property
    def beta_mean(self):
        return (self.beta_max + self.beta_min) / 2

    @property
    def alpha_box(self):
        return self.alpha_max - self.alpha_min

    @property
    def beta_box(self):
        return self.beta_max - self.beta_min

    @property
    def box(self):
        return (self.alpha_box, self.beta_box)

    def fov(self, instr_list, margin: float = 5) -> "CoordList":
        """Smallest/largest Coord covering all instruments and pointings.

        Note: the reference computes beta_max with `min(...)`
        (instru.py:227) — an evident typo; we use `max` here.
        """
        alpha_min = min(ins.fov.bbox[0].alpha for ins in instr_list)
        alpha_max = max(ins.fov.bbox[1].alpha for ins in instr_list)
        beta_min = min(ins.fov.bbox[0].beta for ins in instr_list)
        beta_max = max(ins.fov.bbox[1].beta for ins in instr_list)
        return CoordList(
            [
                Coord(alpha_min - self.alpha_min - margin, beta_min - self.beta_min - margin),
                Coord(alpha_max + self.alpha_max + margin, beta_max + self.beta_max + margin),
            ]
        )

    def pix(self, step: float) -> "CoordList":
        return CoordList(c.pix(step) for c in self)


@dataclass
class FOV:
    """Rotated rectangular field of view (angles in degrees).

    The "local" referential is centered on `origin` with no rotation; the
    "global" referential is the sky frame the FOV lives in.
    Reference: instru.py:256-413.
    """

    alpha_width: float
    beta_width: float
    origin: Coord = None
    angle: float = 0.0

    def __post_init__(self):
        if self.origin is None:
            self.origin = Coord(0, 0)

    def local_coords(
        self, step: float, alpha_margin: float = 0.0, beta_margin: float = 0.0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Regular Cartesian axes spanning the FOV in the local referential.

        Axis construction matches instru.py:283-304: start is floored to a
        multiple of `step`, and the count covers width plus the flooring slack
        (inclusive end point → num+1 samples).
        """

        def axis(start, length, s):
            round_start = int(floor(start / s)) * s
            num = int(ceil((length + (start - round_start)) / s))
            return np.arange(num + 1) * s + round_start

        alpha_axis = axis(-self.alpha_width / 2 - alpha_margin, self.alpha_width + 2 * alpha_margin, step)
        beta_axis = axis(-self.beta_width / 2 - beta_margin, self.beta_width + 2 * beta_margin, step)
        return alpha_axis, beta_axis

    def local2global(self, alpha_coords, beta_coords):
        """Local axes → 2-D fields of global coordinates (outer product + rotation)."""
        alpha_grid, beta_grid = np.meshgrid(alpha_coords, beta_coords, indexing="ij")
        pts = rotmatrix(self.angle) @ np.vstack([alpha_grid.ravel(), beta_grid.ravel()])
        return (
            pts[0].reshape(alpha_grid.shape) + self.origin.alpha,
            pts[1].reshape(beta_grid.shape) + self.origin.beta,
        )

    def global2local(self, alpha_coords, beta_coords):
        """Global axes → 2-D fields of local coordinates."""
        alpha_grid, beta_grid = np.meshgrid(
            np.asarray(alpha_coords) - self.origin.alpha,
            np.asarray(beta_coords) - self.origin.beta,
            indexing="ij",
        )
        pts = rotmatrix(-self.angle) @ np.vstack([alpha_grid.ravel(), beta_grid.ravel()])
        return pts[0].reshape(alpha_grid.shape), pts[1].reshape(beta_grid.shape)

    def coords(self, step: float, alpha_margin: float = 0.0, beta_margin: float = 0.0):
        return self.local2global(*self.local_coords(step, alpha_margin, beta_margin))

    def rotate(self, degree: float) -> None:
        self.angle += degree

    def shift(self, coord: Coord) -> None:
        self.origin = self.origin + coord

    @property
    def vertices(self):
        """Vertices from lower-left, counter-clockwise."""
        half = [
            Coord(-self.alpha_width / 2, -self.beta_width / 2),
            Coord(self.alpha_width / 2, -self.beta_width / 2),
            Coord(self.alpha_width / 2, self.beta_width / 2),
            Coord(-self.alpha_width / 2, self.beta_width / 2),
        ]
        return tuple(c.rotate(self.angle) + self.origin for c in half)

    @property
    def bbox(self):
        verts = self.vertices
        return (
            Coord(min(v.alpha for v in verts), min(v.beta for v in verts)),
            Coord(max(v.alpha for v in verts), max(v.beta for v in verts)),
        )

    @property
    def lower_left(self):
        return self.vertices[0]

    @property
    def lower_right(self):
        return self.vertices[1]

    @property
    def upper_right(self):
        return self.vertices[2]

    @property
    def upper_left(self):
        return self.vertices[3]

    @property
    def local(self) -> "LocalFOV":
        return LocalFOV(self)

    def __add__(self, coord: Coord) -> "FOV":
        return FOV(self.alpha_width, self.beta_width, self.origin + coord, self.angle)

    def __sub__(self, coord: Coord) -> "FOV":
        return FOV(self.alpha_width, self.beta_width, self.origin - coord, self.angle)


class LocalFOV(FOV):
    """A FOV re-expressed in its own local referential (origin 0, angle 0)."""

    def __init__(self, fov: FOV):
        super().__init__(fov.alpha_width, fov.beta_width, Coord(0, 0), 0.0)

    @property
    def alpha_start(self):
        return self.origin.alpha - self.alpha_width / 2

    @property
    def alpha_end(self):
        return self.origin.alpha + self.alpha_width / 2

    @property
    def beta_start(self):
        # round to avoid 1e-17-scale noise flipping the pixel-inclusion tests
        # (reference instru.py:430)
        return round(self.origin.beta - self.beta_width / 2, 9)

    @property
    def beta_end(self):
        return round(self.origin.beta + self.beta_width / 2, 9)

    def to_slices(self, alpha_axis: np.ndarray, beta_axis: np.ndarray) -> Tuple[slice, slice]:
        """Index slices of the axes whose pixels (± half step) touch this FOV.

        Reference: instru.py:436-459.
        """
        da = alpha_axis[1] - alpha_axis[0]
        db = beta_axis[1] - beta_axis[0]
        return (
            slice(
                int(np.flatnonzero(self.alpha_start < alpha_axis + da / 2)[0]),
                int(np.flatnonzero(alpha_axis - da / 2 < self.alpha_end)[-1]) + 1,
            ),
            slice(
                int(np.flatnonzero(self.beta_start < beta_axis + db / 2)[0]),
                int(np.flatnonzero(beta_axis - db / 2 < self.beta_end)[-1]) + 1,
            ),
        )

    def n_alpha(self, step: float) -> int:
        return int(ceil((self.alpha_width / 2) / step)) - int(floor(-self.alpha_width / 2 / step))

    def n_beta(self, step: float) -> int:
        return int(ceil(self.beta_width / 2 / step)) - int(floor(-self.beta_width / 2 / step))

    def __add__(self, coord: Coord) -> "LocalFOV":
        lfov = LocalFOV(self)
        lfov.origin = self.origin + coord
        return lfov

    def __sub__(self, coord: Coord) -> "LocalFOV":
        lfov = LocalFOV(self)
        lfov.origin = self.origin - coord
        return lfov


def generate_pointings(pointing, dither) -> List[Tuple[float, float]]:
    """Absolute pointings = central pointing + each dither offset."""
    return [(pointing[0] + d[0], pointing[1] + d[1]) for d in dither]
