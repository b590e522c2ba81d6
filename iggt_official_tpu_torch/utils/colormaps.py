"""matplotlib's colormaps as the demo uses them, without matplotlib.

The card machine has no matplotlib, so the port keeps the six 256-entry
lookup tables the JAX package reaches through it -- ``jet`` (mask colours,
depth PNGs), ``viridis``, ``plasma``, ``turbo`` (depth PNGs),
``gist_rainbow`` (GLB camera markers) and ``hsv`` (track colours) -- and
matplotlib's float lookup:
index floor(x * 256), 1.0 mapped to 255, values below 0 to the first entry,
above 1 to the last, NaN to black.

``jet``, ``gist_rainbow`` and ``hsv`` are sampled from matplotlib's segment data as
`matplotlib.colors._create_lookup_table` samples it; ``viridis``, ``plasma``
and ``turbo`` are listed colormaps, whose tables were written once from
matplotlib into ``listed_colormaps.npy`` (float64, (3, 256, 3)) beside this
module.  The tests hold all five equal to matplotlib.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict

import numpy as np

N = 256

# matplotlib's `jet` segment data (`matplotlib/_cm.py::_jet_data`): per
# channel, (x, value below x, value above x)
_JET_DATA = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1), (0.910, 0, 0),
              (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.00, 0, 0)),
}
# matplotlib's `gist_rainbow` (`_cm.py::_gist_rainbow_data`): (x, colour) pairs,
# which `LinearSegmentedColormap.from_list` turns into (x, c, c) per channel
_GIST_RAINBOW_POINTS = (
    (0.000, (1.00, 0.00, 0.16)), (0.030, (1.00, 0.00, 0.00)), (0.215, (1.00, 1.00, 0.00)),
    (0.400, (0.00, 1.00, 0.00)), (0.586, (0.00, 1.00, 1.00)), (0.770, (0.00, 0.00, 1.00)),
    (0.954, (1.00, 0.00, 1.00)), (1.000, (1.00, 0.00, 0.75)),
)
# matplotlib's `hsv` segment data (`_cm.py::_hsv_data`)
_HSV_DATA = {
    "red": ((0.0, 1.0, 1.0), (0.15873, 1.0, 1.0), (0.174603, 0.96875, 0.96875),
            (0.333333, 0.03125, 0.03125), (0.349206, 0.0, 0.0), (0.666667, 0.0, 0.0),
            (0.68254, 0.03125, 0.03125), (0.84127, 0.96875, 0.96875),
            (0.857143, 1.0, 1.0), (1.0, 1.0, 1.0)),
    "green": ((0.0, 0.0, 0.0), (0.15873, 0.9375, 0.9375), (0.174603, 1.0, 1.0),
              (0.507937, 1.0, 1.0), (0.666667, 0.0625, 0.0625), (0.68254, 0.0, 0.0),
              (1.0, 0.0, 0.0)),
    "blue": ((0.0, 0.0, 0.0), (0.333333, 0.0, 0.0), (0.349206, 0.0625, 0.0625),
             (0.507937, 1.0, 1.0), (0.84127, 1.0, 1.0), (0.857143, 0.9375, 0.9375),
             (1.0, 0.09375, 0.09375)),
}
_LISTED = ("viridis", "plasma", "turbo")


def _segment_lut(data, n: int = N) -> np.ndarray:
    """A LinearSegmentedColormap channel sampled at i / (n - 1), computed as
    matplotlib's `colors._create_lookup_table` computes it (gamma 1)."""
    adata = np.asarray(data, np.float64)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _from_points(points) -> Dict[str, tuple]:
    return {ch: tuple((x, c[i], c[i]) for x, c in points)
            for i, ch in enumerate(("red", "green", "blue"))}


def _segmented(data) -> np.ndarray:
    return np.stack([_segment_lut(data[ch]) for ch in ("red", "green", "blue")], 1)


LUTS: Dict[str, np.ndarray] = {
    "jet": _segmented(_JET_DATA),
    "gist_rainbow": _segmented(_from_points(_GIST_RAINBOW_POINTS)),
    "hsv": _segmented(_HSV_DATA),
    **dict(zip(_LISTED, np.load(Path(__file__).with_name("listed_colormaps.npy")))),
}
JET_LUT = LUTS["jet"]


def lookup(lut: np.ndarray, x) -> np.ndarray:
    """matplotlib's float lookup: (...,) floats -> (..., 3) float64 RGB.  The
    scaling by the table size runs in x's own float type, as matplotlib's
    does, so float32 and float64 inputs pick the entries matplotlib picks."""
    xa = np.array(x, copy=True)
    n = len(lut)
    bad = np.isnan(xa)
    xa *= n
    xa[xa == n] = n - 1
    under, over = xa < 0, xa >= n
    with np.errstate(invalid="ignore"):
        idx = xa.astype(np.int64)
    idx[under] = 0
    idx[over] = n - 1
    idx[bad] = 0
    rgb = lut[idx]
    rgb[bad] = 0.0
    return rgb


def get_cmap(name: str) -> Callable[[np.ndarray], np.ndarray]:
    """x -> (..., 3) float64 RGB of the colormap ``name``."""
    lut = LUTS[name]
    return lambda x: lookup(lut, x)


jet = get_cmap("jet")
