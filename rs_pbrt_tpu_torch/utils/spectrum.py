"""Sampled spectra to RGB: the part of the JAX package's
``utils/spectrum.py`` that the metal material needs (reference
src/core/spectrum.rs from_sampled and materials/metal.rs's copper).

``spd_to_rgb`` and ``copper_rgb`` are host numpy code, run when a scene is
built.  The CIE 1931 curves (471 samples) and the measured copper spectra
come from ``data/spectrum_tables.npz``, the port's copy of those arrays of
the JAX package's data file.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

_DATA = np.load(Path(__file__).resolve().parent.parent / "data" / "spectrum_tables.npz")

CIE_LAMBDA = _DATA["cie_lambda"]
CIE_X = _DATA["cie_x"]
CIE_Y = _DATA["cie_y"]
CIE_Z = _DATA["cie_z"]
N_CIE_SAMPLES = 471
CIE_Y_INTEGRAL = 106.856895  # spectrum.rs:1481
XYZ_TO_RGB = np.array([[3.240479, -1.537150, -0.498535],
                       [-0.969256, 1.875991, 0.041556],
                       [0.055648, -0.204043, 1.057311]])


def spd_to_rgb(lambdas, values) -> np.ndarray:
    """An SPD resampled to RGB (spectrum.rs:1585 from_sampled): sorted by
    wavelength, interpolated piecewise-linearly at the CIE samples,
    integrated against the CIE curves and taken from XYZ to RGB.  (3,)
    f32."""
    lambdas = np.asarray(lambdas, np.float64)
    values = np.asarray(values, np.float64)
    order = np.argsort(lambdas)
    interp = np.interp(CIE_LAMBDA.astype(np.float64), lambdas[order], values[order])
    xyz = np.array([np.sum(interp * c.astype(np.float64)) for c in (CIE_X, CIE_Y, CIE_Z)])
    xyz *= (CIE_LAMBDA[-1] - CIE_LAMBDA[0]) / (CIE_Y_INTEGRAL * N_CIE_SAMPLES)
    return (XYZ_TO_RGB @ xyz).astype(np.float32)


@lru_cache(maxsize=None)
def copper_rgb() -> tuple:
    """Measured copper's (eta, k), each resampled to RGB as a tuple of 3
    floats (metal.rs:108-121): the metal material's default."""
    wl = _DATA["copper_wavelengths"]
    eta = tuple(float(v) for v in spd_to_rgb(wl, _DATA["copper_n"]))
    k = tuple(float(v) for v in spd_to_rgb(wl, _DATA["copper_k"]))
    return eta, k
