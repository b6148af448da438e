"""Light power for the light-selection distribution.

The port's copy of ``compute_light_power`` from the JAX package's
``models/lights.py`` (reference core/integrator.rs:574
compute_light_power_distribution).  Host-side numpy: it runs once when a
scene is finalized.
"""

from __future__ import annotations

import numpy as np

from ..scene import arrays as sa


def compute_light_power(light_type, light_params, env_total: float = 0.0) -> np.ndarray:
    """(L,) approximate power of each light, floored at 1e-9."""
    lp = np.asarray(light_params, np.float32)
    light_type = np.asarray(light_type)
    lum = lp[:, sa.LP_I:sa.LP_I + 3].sum(-1)
    area = lp[:, sa.LP_AREA]
    wr = lp[:, sa.LP_WORLD_RADIUS]
    power = np.zeros(len(light_type), np.float32)
    power = np.where(light_type == sa.LIGHT_POINT, 4 * np.pi * lum, power)
    power = np.where(light_type == sa.LIGHT_SPOT, 2 * np.pi * lum, power)
    power = np.where(light_type == sa.LIGHT_DISTANT, np.pi * wr * wr * lum, power)
    two = 1.0 + (lp[:, sa.LP_TWO_SIDED] > 0.5)
    power = np.where(light_type == sa.LIGHT_AREA, two * area * np.pi * lum, power)
    power = np.where(light_type == sa.LIGHT_INFINITE, np.pi * wr * wr * env_total, power)
    return np.maximum(power, 1e-9).astype(np.float32)
