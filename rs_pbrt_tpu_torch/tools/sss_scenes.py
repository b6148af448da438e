"""BASELINE config 4 and a grid-medium variant of it, built through the
port's own scene builder.

- ``sss_dragonette``: ``assets/scenes/sss_dragonette.pbrt`` transcribed
  call for call (the port has no scene-file parser yet): a subsurface
  sphere of radius 0.45 (the material's default coefficients, eta 1.33;
  the file names no measured preset) on a matte floor of two triangles,
  lit by two point lights.
- ``smoke_dragonette``: the same scene with the camera in a heterogeneous
  medium whose grid spans (-2, 0, -2) to (2, 2, 2): sigma_a 0.02, sigma_s
  0.4 on every channel, g 0.3, and a (grid_res,)^3 f32 density, a sum of
  SMOKE_PUFFS Gaussian puffs made by numpy from `seed`, scaled to a
  maximum of 1 (``smoke_grid``).  The surfaces are no medium interfaces,
  so every ray stays in the smoke, which is empty outside the grid.

Each returns (scene, camera) on `device`.  ``build`` makes the calls on a
builder it is given, so the JAX package's SceneBuilder, which takes the
same calls, builds the same tables from the same grid.  ``CFG`` is the
file's Integrator and Sampler: volpath, depth 6, 16 spp (bench.py renders
config 4 at BENCH_SPP in batches of BENCH_LANES paths); its film is
200x200 with a box filter.  To render one on the card::

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.tools import sss_scenes

    scene, camera = sss_scenes.sss_dragonette()
    img = rdr.render(scene, camera, sss_scenes.CFG._replace(spp=512),
                     smpl.make_sampler(smpl.SOBOL, 512, camera.resolution),
                     max_lanes=sss_scenes.BENCH_LANES)
"""

from __future__ import annotations

import numpy as np

from ..models import cameras as cam
from ..models.integrators.render import RenderCfg
from ..scene.builder import SceneBuilder
from ..utils import transform as tr

CFG = RenderCfg("volpath", spp=16, max_depth=6, rr_threshold=1.0)
RESOLUTION = (200, 200)
BENCH_SPP = 512  # bench.py:288-306 bench_sss
BENCH_LANES = 1 << 22  # bench.py:298
SMOKE_PUFFS = 32
SMOKE_BOX = ((-2.0, 0.0, -2.0), (2.0, 2.0, 2.0))  # the grid's world extent


def smoke_grid(grid_res: int = 128, seed: int = 0) -> np.ndarray:
    """(grid_res,)^3 f32 densities (z, y, x): SMOKE_PUFFS Gaussian puffs of
    random centres, widths and weights, scaled to a maximum of 1."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(0.15, 0.85, (SMOKE_PUFFS, 3))
    width = rng.uniform(0.04, 0.15, SMOKE_PUFFS)
    weight = rng.uniform(0.3, 1.0, SMOKE_PUFFS)
    c = (np.arange(grid_res) + 0.5) / grid_res
    grid = np.zeros((grid_res,) * 3, np.float64)
    for (x, y, z), w, a in zip(centre, width, weight):
        gz, gy, gx = (np.exp(-((c - v) ** 2) / (2 * w * w)) for v in (z, y, x))
        grid += a * gz[:, None, None] * gy[None, :, None] * gx[None, None, :]
    return (grid / grid.max()).astype(np.float32)


def build(b, smoke=None):
    """The file's calls on builder b (this package's SceneBuilder or one
    with its calls); smoke: a density grid to put the camera in.  Returns
    b."""
    if smoke is not None:
        lo, hi = np.asarray(SMOKE_BOX[0]), np.asarray(SMOKE_BOX[1])
        m2w = tr.compose(tr.translate(lo), tr.scale(*(hi - lo)))
        b.camera_medium = b.add_medium(sigma_a=(0.02,) * 3, sigma_s=(0.4,) * 3, g=0.3,
                                       density_grid=smoke, medium_to_world=m2w)
    milk = b.add_subsurface()
    floor = b.add_matte(kd=(0.3, 0.3, 0.3))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        np.asarray([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32),
                        material=floor)
    b.add_sphere(tr.translate([0, 0.45, 0]), radius=0.45, material=milk)
    b.add_point_light(p=(0, 1.2, -2.5), I=(50, 50, 50))
    b.add_point_light(p=(2, 2, 2), I=(8, 8, 8))
    return b


def camera(resolution=RESOLUTION, device="cuda"):
    """The file's camera: LookAt 0 0.4 2.6  0 0.3 0  0 1 0, fov 35."""
    return cam.make_perspective(tr.look_at([0, 0.4, 2.6], [0, 0.3, 0], [0, 1, 0]), resolution,
                                fov=35.0, device=device)


def sss_dragonette(resolution=RESOLUTION, device="cuda"):
    """assets/scenes/sss_dragonette.pbrt: (scene, camera)."""
    return build(SceneBuilder()).finalize(device), camera(resolution, device)


def smoke_dragonette(grid_res: int = 128, seed: int = 0, resolution=RESOLUTION, device="cuda"):
    """The dragonette with the camera in smoke (see the module's
    docstring): (scene, camera)."""
    b = build(SceneBuilder(), smoke_grid(grid_res, seed))
    return b.finalize(device), camera(resolution, device)
