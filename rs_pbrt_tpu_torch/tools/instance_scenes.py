"""Seeded scenes of instancing, object motion and the kd-tree.

pbrt's instanced scenes (the ecosystem and landscape sets) are not in the
repository, so these stand in for them, built by numpy from a seed on
either package's builder (this package's SceneBuilder, or the JAX
package's, whose calls are the same), as ``scene/bigscene.statue_build``
is:

- ``forest_build``: the statue's displaced icosphere (``bigscene``) as one
  prototype, placed ``grid`` x ``grid`` times on a lattice, each instance
  with its own yaw, a scale in 0.6-1.2 and one of three matte overrides, on
  a ground quad under a quad area light.  At subdivisions 6 and an 8x8
  grid: 64 instances of 81,920 triangles, 5,242,880 in view, one stored.
  The lattice is tight enough that the tallest instances' boxes overlap,
  so grazing rays enter more boxes than the walk keeps
  (``instancing.K_CANDIDATES``).
- ``moving_build``: the Cornell box with an icosphere(3) (1,280
  triangles) as an animated mesh that rises 120 units and turns 30
  degrees about y across the shutter.

The kd-tree's scene is the statue itself (``bigscene.statue_build``)
rendered with ``accelerator="kdtree"``.
"""

from __future__ import annotations

import numpy as np

from ..models import cameras as cam
from ..scene import bigscene
from ..scene import presets
from ..scene.builder import SceneBuilder
from ..utils import transform as tr

SPACING = 2.6  # the lattice's pitch, in the statue's units (its radius ~1.2)
FOREST_MATS = ((0.55, 0.52, 0.48), (0.35, 0.5, 0.3), (0.6, 0.35, 0.25))


def _rot_y(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float64)


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def statue_mesh(subdivisions: int):
    """(vertices (V, 3) f32, faces (F, 3)): the statue's displaced
    icosphere, resting on y = 0."""
    v, f = bigscene.icosphere(subdivisions)
    disp = 1.0 + 0.18 * bigscene._fbm3(v) + 0.05 * bigscene._fbm3(2.7 * v, seed=13)
    v = v * disp[:, None]
    v[:, 1] -= v[:, 1].min()
    return v.astype(np.float32), f


def forest_extent(grid: int) -> float:
    """Half the lattice's width."""
    return 0.5 * (grid - 1) * SPACING


def forest_build(b, subdivisions=6, grid=8, seed=0):
    """The forest's calls on builder b (see the module's docstring).
    Returns b."""
    v, f = statue_mesh(subdivisions)
    proto = b.add_prototype_mesh(f, v, material=b.add_matte(kd=(0.5, 0.5, 0.5)))
    mats = [b.add_matte(kd=kd) for kd in FOREST_MATS]
    rng = np.random.default_rng(seed)
    n = grid * grid
    yaw = rng.uniform(0.0, 2.0 * np.pi, n)
    scale = rng.uniform(0.6, 1.2, n)
    pick = rng.integers(0, len(mats), n)
    half = forest_extent(grid)
    for k in range(n):
        i, j = divmod(k, grid)
        m = (_translate(-half + j * SPACING, 0.0, -half + i * SPACING) @ _rot_y(yaw[k])
             @ np.diag([scale[k], scale[k], scale[k], 1.0]))
        b.add_instance(proto, tr.from_matrix(m), material=mats[pick[k]])
    g = half + SPACING
    ground = b.add_matte(kd=(0.4, 0.4, 0.4))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], [[-g, 0, -g], [-g, 0, g], [g, 0, g], [g, 0, -g]],
                        material=ground)
    top, size = 3.0 * g, 0.35 * g
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-size, top, -size], [size, top, -size], [size, top, size],
                         [-size, top, size]],
                        material=b.add_matte(kd=(0.0, 0.0, 0.0)),
                        area_light=dict(L=(60.0, 56.0, 52.0), two_sided=False))
    return b


def forest_view(grid: int):
    """(eye, look, up, fov) of the forest's camera: above the lattice's
    front edge, looking across it."""
    half = forest_extent(grid)
    return ((0.0, 1.2 * half + 2.0, 2.2 * half + 4.0), (0.0, 0.6, -0.25 * half), (0, 1, 0), 50.0)


def forest_scene(resolution=(256, 256), subdivisions=6, grid=8, seed=0, device="cuda"):
    """(scene, camera) of forest_build on `device`."""
    scene = forest_build(SceneBuilder(), subdivisions, grid, seed).finalize(device)
    eye, look, up, fov = forest_view(grid)
    return scene, cam.make_perspective(tr.look_at(eye, look, up), resolution, fov=fov,
                                       device=device)


def moving_build(b, subdivisions=3):
    """The Cornell box with an icosphere(subdivisions) as an animated mesh:
    radius 75 at (170, 90, 140) at the shutter's open, 120 higher and
    turned 30 degrees about y at its close.  Returns b."""
    presets.cornell_build(b)
    v, f = bigscene.icosphere(subdivisions)
    s = np.diag([75.0, 75.0, 75.0, 1.0])
    start = tr.from_matrix(_translate(170.0, 90.0, 140.0) @ s)
    end = tr.from_matrix(_translate(170.0, 210.0, 140.0) @ _rot_y(np.pi / 6.0) @ s)
    b.add_animated_triangle_mesh(f, v.astype(np.float32), start, end, normals=v.astype(np.float32),
                                 material=b.add_matte(kd=(0.2, 0.3, 0.7)))
    return b


def moving_scene(resolution=(256, 256), subdivisions=3, device="cuda"):
    """(scene, camera) of moving_build on `device`, the flagship's Cornell
    camera, whose shutter spans 0-1."""
    scene = moving_build(SceneBuilder(), subdivisions).finalize(device)
    return scene, presets.cornell_camera(resolution, device)
