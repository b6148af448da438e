"""RGB spectra and colorimetry: the port of the JAX package's
``utils/spectrum.py`` (reference src/core/spectrum.rs; its Spectrum is
RGBSpectrum, so a spectrum is an ``(..., 3)`` array).

Everything here is host numpy code, run when a scene is built or parsed:
the luminance and the XYZ conversions, the sRGB curves, Planck's law, and
sampled spectra resampled to RGB (``spd_to_rgb``, measured copper for the
metal material).  The CIE 1931 curves (471 samples) and the measured copper spectra
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
RGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                       [0.212671, 0.715160, 0.072169],
                       [0.019334, 0.119193, 0.950227]])
LUMINANCE = np.array([0.212671, 0.715160, 0.072169])


def _floats(x) -> np.ndarray:
    """x as f32, the JAX package's width for these functions."""
    return np.asarray(x, np.float32)


def luminance(rgb) -> np.ndarray:
    """y() luminance over the last axis (spectrum.rs:1581)."""
    rgb = _floats(rgb)
    return np.sum(rgb * LUMINANCE.astype(np.float32), axis=-1)


def rgb_to_xyz(rgb) -> np.ndarray:
    """spectrum.rs:1822-1836."""
    rgb = _floats(rgb)
    return np.einsum("ij,...j->...i", RGB_TO_XYZ.astype(np.float32), rgb)


def xyz_to_rgb(xyz) -> np.ndarray:
    xyz = _floats(xyz)
    return np.einsum("ij,...j->...i", XYZ_TO_RGB.astype(np.float32), xyz)


def gamma_correct(v) -> np.ndarray:
    """sRGB OETF (spectrum.rs:1865)."""
    v = _floats(v)
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * np.power(np.maximum(v, 1e-8), 1.0 / 2.4) - 0.055)


def inverse_gamma_correct(v) -> np.ndarray:
    v = _floats(v)
    with np.errstate(invalid="ignore"):
        return np.where(v <= 0.04045, v / 12.92, np.power((v + 0.055) / 1.055, 2.4))


def is_black(rgb) -> np.ndarray:
    return np.all(np.asarray(rgb) == 0.0, axis=-1)


def blackbody(lambda_nm, temperature) -> np.ndarray:
    """Planck's law, W/(m^2 sr m), at wavelengths in nm (spectrum.rs:1483);
    f32, zeros for a temperature at or below 0."""
    lam = np.asarray(lambda_nm, np.float64) * 1e-9
    t = float(temperature)
    if t <= 0.0:
        return np.zeros_like(lam, dtype=np.float32)
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    le = (2.0 * h * c * c) / (lam ** 5 * (np.exp((h * c) / (lam * kb * t)) - 1.0))
    return le.astype(np.float32)


def blackbody_normalized(lambda_nm, temperature) -> np.ndarray:
    """blackbody over its peak (Wien's displacement law)."""
    le = blackbody(lambda_nm, temperature)
    lambda_max = 2.8977721e-3 / temperature * 1e9
    return le / blackbody(np.array([lambda_max]), temperature)[0]


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
