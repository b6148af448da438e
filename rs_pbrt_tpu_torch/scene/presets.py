"""Built-in scenes (host-side constructors).

The port's copies of two scenes of the JAX package's ``scene/presets.py``,
with identical geometry: ``cornell_box``, the classic Cornell data set in
cm units (white floor, ceiling and back wall, red left wall, green right
wall, two boxes, a ceiling area light), and ``spheres_direct``, matte and
mirror spheres on a floor under a quad light and a sphere light.
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


def spheres_direct(resolution=(256, 256), device="cuda"):
    """BASELINE config 2's scene: a matte and a mirror sphere on a floor,
    lit by a quad area light overhead and a sphere area light to the side,
    for the directlighting and whitted integrators.  Returns (scene,
    camera) on `device`."""
    b = SceneBuilder()
    floor = b.add_matte(kd=(0.6, 0.6, 0.6))
    matte = b.add_matte(kd=(0.5, 0.2, 0.2))
    mirror = b.add_mirror(kr=(0.9, 0.9, 0.9))
    dark = b.add_matte(kd=(0.0, 0.0, 0.0))
    _quad(b, [-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6], floor)
    b.add_sphere(tr.translate([-1.1, 1.0, 0]), radius=1.0, material=matte)
    b.add_sphere(tr.translate([1.1, 1.0, 0.4]), radius=1.0, material=mirror)
    _quad(b, [-1.5, 4.0, -1.0], [-0.5, 4.0, -1.0], [-0.5, 4.0, 0.0], [-1.5, 4.0, 0.0], dark,
          area_light=dict(L=(18.0, 18.0, 18.0), two_sided=False))
    b.add_sphere(tr.translate([2.5, 2.5, -2.0]), radius=0.3, material=dark,
                 area_light=dict(L=(40.0, 40.0, 40.0)))
    scene = b.finalize(device)
    camera = cam.make_perspective(tr.look_at([0, 2.2, 6.5], [0, 1.0, 0], [0, 1, 0]), resolution,
                                  fov=45.0, device=device)
    return scene, camera
