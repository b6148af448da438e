"""BASELINE config 5, the SPPM showcase scenes, built through the port's own
scene builder.

- ``caustic_only``: ``assets/scenes/caustic_only.pbrt`` transcribed call
  for call (the port has no scene-file parser yet): a smooth glass sphere
  (index 1.5, radius 0.4) over a matte floor of two triangles, lit by two
  point lights.
- ``caustic_hair``: ``assets/scenes/caustic_hair.pbrt``, the same scene
  and two cylinder curves of the hair material (eumelanin 1.3, beta_m
  0.25, beta_n 0.3) in its order: 48 segments.

Each returns (scene, camera) on `device`.  ``CFG`` is the files'
Integrator: sppm, 16 iterations, depth 5, with one photon a pixel an
iteration; their Sampler is random, 1 spp, and their film 200x200.  To
render one on the card::

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.tools import caustic_scenes

    scene, camera = caustic_scenes.caustic_hair()
    img = rdr.render(scene, camera, caustic_scenes.CFG,
                     smpl.make_sampler(smpl.RANDOM, 1, camera.resolution),
                     accel=si.build_accel(scene))
"""

from __future__ import annotations

import numpy as np

from ..models import cameras as cam
from ..models.integrators.render import RenderCfg
from ..scene.builder import SceneBuilder
from ..utils import transform as tr

# the files' Integrator (the JAX parser's sppm defaults: photons 0 gives
# one a pixel; the radius is the files' default 1)
CFG = RenderCfg("sppm", spp=1, max_depth=5, rr_threshold=1.0,
                extra={"n_iterations": 16, "photons_per_iteration": -1, "initial_radius": 1.0})
RESOLUTION = (200, 200)

# caustic_hair.pbrt's two curves (cylinder, splitdepth 2, width 0.06 to 0.02)
HAIR_CURVES = (
    [[0.35, 0, 0], [0.45, 0.4, 0.05], [0.55, 0.8, 0.0], [0.75, 1.05, -0.1]],
    [[0.6, 0, 0.15], [0.7, 0.4, 0.15], [0.85, 0.75, 0.1], [1.0, 1.0, 0.05]],
)


def _build(with_hair: bool, resolution, device):
    b = SceneBuilder()
    glass = b.add_glass(kr=(1, 1, 1), kt=(1, 1, 1), eta=1.5)
    b.add_sphere(tr.translate([-0.55, 0.75, 0.2]), radius=0.4, material=glass)
    if with_hair:
        hair = b.add_hair(eumelanin=1.3, beta_m=0.25, beta_n=0.3)
        for cps in HAIR_CURVES:
            b.add_curve(np.asarray(cps, np.float32), width0=0.06, width1=0.02,
                        curve_type="cylinder", splitdepth=2, material=hair)
    floor = b.add_matte(kd=(0.5, 0.5, 0.5))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        np.asarray([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32),
                        material=floor)
    b.add_point_light(p=(-0.55, 2.6, 0.2), I=(30, 30, 30))
    b.add_point_light(p=(2.5, 2.5, 2.5), I=(10, 10, 12))
    camera = cam.make_perspective(tr.look_at([0, 1.3, 3.4], [0, 0.45, 0], [0, 1, 0]), resolution,
                                  fov=42.0, device=device)
    return b.finalize(device), camera


def caustic_only(resolution=RESOLUTION, device="cuda"):
    """assets/scenes/caustic_only.pbrt: (scene, camera)."""
    return _build(False, resolution, device)


def caustic_hair(resolution=RESOLUTION, device="cuda"):
    """assets/scenes/caustic_hair.pbrt: (scene, camera)."""
    return _build(True, resolution, device)
