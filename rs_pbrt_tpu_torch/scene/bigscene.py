"""The statue: a large procedural scene for the BVH path.

The port's own copy of the JAX package's ``scene/bigscene.py`` (the
benchmark's stand-in for the reference's 4.3M-triangle statue scan,
reference README.md:53-61): a displaced icosphere, a matte ground and an
overhead quad area light.  Built with vectorized numpy, so a 1.3M-triangle
mesh assembles in seconds.
"""

from __future__ import annotations

import numpy as np

from ..models import cameras as cam
from ..utils import transform as tr
from .builder import SceneBuilder

_ICO_T = (1.0 + np.sqrt(5.0)) / 2.0
_ICO_V = np.array(
    [
        [-1, _ICO_T, 0], [1, _ICO_T, 0], [-1, -_ICO_T, 0], [1, -_ICO_T, 0],
        [0, -1, _ICO_T], [0, 1, _ICO_T], [0, -1, -_ICO_T], [0, 1, -_ICO_T],
        [_ICO_T, 0, -1], [_ICO_T, 0, 1], [-_ICO_T, 0, -1], [-_ICO_T, 0, 1],
    ],
    np.float64,
)
_ICO_F = np.array(
    [
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ],
    np.int64,
)


def icosphere(subdivisions: int):
    """Unit icosphere: (vertices, faces) with 20 * 4^n triangles, by
    vectorized midpoint subdivision."""
    v = _ICO_V / np.linalg.norm(_ICO_V, axis=1, keepdims=True)
    f = _ICO_F
    for _ in range(subdivisions):
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = len(v) + inv.reshape(3, -1)  # midpoint vertex ids per face edge
        v = np.concatenate([v, mid])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        mab, mbc, mca = m[0], m[1], m[2]
        f = np.concatenate([
            np.stack([a, mab, mca], 1),
            np.stack([b, mbc, mab], 1),
            np.stack([c, mca, mbc], 1),
            np.stack([mab, mbc, mca], 1),
        ])
    return v, f


def _fbm3(p, octaves=5, seed=7):
    """Value-noise fbm on the sphere from random-frequency cosines (the
    displacement's detail)."""
    rs = np.random.RandomState(seed)
    out = np.zeros(p.shape[0])
    amp = 1.0
    freq = 2.0
    for _ in range(octaves):
        k = rs.normal(size=(3, 3)) * freq
        ph = rs.uniform(0, 2 * np.pi, 3)
        out += amp * np.cos(p @ k.T + ph).sum(1) / 3.0
        amp *= 0.55
        freq *= 2.1
    return out


def statue_build(b, subdivisions=8):
    """The statue's calls on builder b (this package's SceneBuilder or one
    with its calls): the displaced icosphere (20 * 4^n triangles: n = 8
    gives 1,310,720, n = 9 5,242,880), all matte, on a ground quad, lit by
    one 2-triangle quad area light overhead.  Returns b."""
    v, f = icosphere(subdivisions)
    disp = 1.0 + 0.18 * _fbm3(v) + 0.05 * _fbm3(2.7 * v, seed=13)
    v = v * disp[:, None]
    v = v * 1.0 + np.array([0.0, 1.25, 0.0])  # rest on the ground

    grey = b.add_matte(kd=(0.55, 0.52, 0.48))
    ground = b.add_matte(kd=(0.4, 0.4, 0.4))
    light_mat = b.add_matte(kd=(0.0, 0.0, 0.0))

    b.add_triangle_mesh(f, v, material=grey)
    g = 8.0
    # ground normal up, light normal down (toward the scene)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-g, 0, -g], [-g, 0, g], [g, 0, g], [g, 0, -g]], material=ground)
    b.add_triangle_mesh(
        [[0, 1, 2], [0, 2, 3]],
        [[-1.2, 5.0, -1.2], [1.2, 5.0, -1.2], [1.2, 5.0, 1.2], [-1.2, 5.0, 1.2]],
        material=light_mat, area_light=dict(L=(14.0, 13.0, 12.0), two_sided=False),
    )
    return b


def statue_camera(resolution=(256, 256), device="cuda"):
    return cam.make_perspective(tr.look_at([0.0, 1.7, 4.2], [0.0, 1.15, 0.0], [0, 1, 0]),
                                resolution, fov=36.0, device=device)


def statue_scene(resolution=(256, 256), subdivisions=8, device="cuda"):
    """(scene, camera): statue_build's scene on `device`."""
    scene = statue_build(SceneBuilder(), subdivisions).finalize(device)
    return scene, statue_camera(resolution, device)
