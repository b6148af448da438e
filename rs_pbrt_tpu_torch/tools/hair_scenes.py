"""The hair scenes: the hair_patch showcase and a fur patch, built through
the port's own scene builder.

- ``hair_patch``: ``assets/scenes/hair_patch.pbrt`` transcribed call for
  call (the port has no scene-file parser yet): three cylinder curves of
  the hair material (eumelanin 1.3, beta_m 0.25, beta_n 0.3), 48 segments,
  over a matte floor of two triangles, lit by two point lights.  Its file
  renders it at 200x200, 16 spp, path, depth 5.
- ``fur_patch``: n_fibers fibres of a hair material standing on the same
  floor under the same lights and camera, each a cylinder curve from
  width 0.01 at its root to 0.004 at its tip, their roots spread uniformly
  over a unit square (the fibres of the JAX package's hair-patch render
  test, tests/test_curves_hair.py); 8,192 fibres flatten to 262,144
  segments, which are walked through their tree.

Each returns (scene, camera) on `device`, and ``CFG`` is the render
configuration of the scene file.  To render either on the card::

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.tools import hair_scenes

    scene, camera = hair_scenes.fur_patch()
    img = rdr.render(scene, camera, hair_scenes.CFG,
                     smpl.make_sampler(smpl.SOBOL, hair_scenes.CFG.spp, camera.resolution),
                     accel=si.build_accel(scene))
"""

from __future__ import annotations

import numpy as np

from ..models import cameras as cam
from ..models.integrators.render import RenderCfg
from ..scene.builder import SceneBuilder
from ..utils import transform as tr

# the scene file's Integrator and Sampler: path, depth 5, 16 spp
CFG = RenderCfg("path", spp=16, max_depth=5, rr_threshold=1.0)
RESOLUTION = (200, 200)

# the three curves of hair_patch.pbrt (cylinder, splitdepth 2, width 0.06 to 0.02)
PATCH_CURVES = (
    [[-0.4, 0, 0], [-0.3, 0.4, 0.05], [-0.2, 0.8, 0.0], [0.0, 1.1, -0.1]],
    [[0.0, 0, 0.1], [0.1, 0.4, 0.1], [0.25, 0.8, 0.05], [0.45, 1.05, 0.0]],
    [[0.3, 0, -0.2], [0.35, 0.4, -0.15], [0.45, 0.75, -0.1], [0.6, 1.0, -0.05]],
)


def _floor_lights_camera(b: SceneBuilder, resolution, device):
    """The scene file's matte floor, its two point lights and its camera."""
    floor = b.add_matte(kd=(0.4, 0.4, 0.45))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        np.asarray([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
                        material=floor)
    b.add_point_light(p=(2, 3, 2), I=(40, 40, 40))
    b.add_point_light(p=(-2, 2, -1), I=(15, 18, 22))
    return cam.make_perspective(tr.look_at([0, 1.2, 3.2], [0, 0.5, 0], [0, 1, 0]), resolution,
                                fov=40.0, device=device)


def hair_patch(resolution=RESOLUTION, device="cuda"):
    """assets/scenes/hair_patch.pbrt: (scene, camera)."""
    b = SceneBuilder()
    hair = b.add_hair(eumelanin=1.3, beta_m=0.25, beta_n=0.3)
    for cps in PATCH_CURVES:
        b.add_curve(np.asarray(cps, np.float32), width0=0.06, width1=0.02,
                    curve_type="cylinder", splitdepth=2, material=hair)
    camera = _floor_lights_camera(b, resolution, device)
    return b.finalize(device), camera


def fur_patch(n_fibers: int = 8192, seed: int = 0, resolution=RESOLUTION, width0=0.01,
              width1=0.004, device="cuda"):
    """n_fibers fibres on hair_patch's floor, lights and camera: (scene,
    camera).  Each fibre's root lies at (x, 0, z), x and z uniform in
    [-0.5, 0.5) from numpy's generator of `seed`, and its control points
    lean +x as they rise to 1."""
    b = SceneBuilder()
    hair = b.add_hair(sigma_a=(0.06, 0.1, 0.2), beta_m=0.3, beta_n=0.3)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, n_fibers)
    z = rng.uniform(-0.5, 0.5, n_fibers)
    cps = np.stack([np.stack([x, np.zeros(n_fibers), z], -1),
                    np.stack([x + 0.1, np.full(n_fibers, 0.33), z], -1),
                    np.stack([x + 0.2, np.full(n_fibers, 0.66), z], -1),
                    np.stack([x + 0.4, np.full(n_fibers, 1.0), z], -1)], axis=1).astype(np.float32)
    b.add_curve(cps, width0=width0, width1=width1, curve_type="cylinder", splitdepth=2,
                material=hair)
    camera = _floor_lights_camera(b, resolution, device)
    return b.finalize(device), camera
