"""Built-in scenes (host-side constructors).

The port's copy of ``cornell_box`` from the JAX package's
``scene/presets.py``: the classic Cornell data set in cm units (white
floor, ceiling and back wall, red left wall, green right wall, two boxes,
a ceiling area light), with identical geometry.
"""

from __future__ import annotations

import numpy as np

from ..models import cameras as cam
from ..utils import transform as tr
from .builder import SceneBuilder


def _quad(b, p0, p1, p2, p3, material, area_light=None):
    """Two triangles for quad p0..p3 (counter-clockwise)."""
    pos = np.asarray([p0, p1, p2, p3], np.float32)
    return b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], pos, material=material,
                               area_light=area_light)


def _box_quads(top, y0, y1):
    """Quads of a box given its 4 top corners (at y1) and base height y0."""
    t = [np.asarray(p, np.float32) for p in top]
    bo = [np.asarray([p[0], y0, p[2]], np.float32) for p in top]
    quads = [tuple(t)]  # top
    for i in range(4):
        j = (i + 1) % 4
        quads.append((t[i], bo[i], bo[j], t[j]))  # sides
    return quads


def cornell_box(resolution=(256, 256), light_scale=1.0, boxes=True, device="cuda"):
    """Returns (scene, camera) on `device`."""
    b = SceneBuilder()
    white = b.add_matte(kd=(0.73, 0.73, 0.73))
    red = b.add_matte(kd=(0.65, 0.05, 0.05))
    green = b.add_matte(kd=(0.12, 0.45, 0.15))
    light_mat = b.add_matte(kd=(0.0, 0.0, 0.0))

    # floor / ceiling / back wall / right x=556 (green) / left x=0 (red)
    _quad(b, [552.8, 0, 0], [0, 0, 0], [0, 0, 559.2], [549.6, 0, 559.2], white)
    _quad(b, [556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2], [0, 548.8, 0], white)
    _quad(b, [549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2], [556, 548.8, 559.2], white)
    _quad(b, [556, 0, 0], [556, 0, 559.2], [556, 548.8, 559.2], [556, 548.8, 0], green)
    _quad(b, [0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2], red)

    if boxes:
        # short block (image right-front), tall block (image left-behind)
        for q in _box_quads([[426, 165, 65], [474, 165, 225], [316, 165, 272], [266, 165, 114]],
                            0.0, 165.0):
            _quad(b, *q, white)
        for q in _box_quads([[133, 330, 247], [291, 330, 296], [242, 330, 456], [84, 330, 406]],
                            0.0, 330.0):
            _quad(b, *q, white)

    # ceiling light (343..213 x, 227..332 z, just below the ceiling)
    L = np.asarray([50.0, 50.0, 50.0], np.float32) * light_scale
    _quad(b, [343, 548.75, 227], [343, 548.75, 332], [213, 548.75, 332], [213, 548.75, 227],
          light_mat, area_light=dict(L=tuple(L), two_sided=False))

    scene = b.finalize(device)
    camera = cam.make_perspective(
        tr.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]), resolution, fov=39.3077,
        device=device,
    )
    return scene, camera
