"""Scenes of analytic quadrics and quadric lights under a sky map.

- ``sky_map``: an equirect (h, w, 3) f32 radiance map made by numpy from a
  seed, +z of its light space up: a sky brighter at the horizon than at
  the zenith, low-frequency clouds, a dim ground below the horizon, and a
  sun of SUN_RADIUS_DEG angular radius at SUN_GAIN times the sky's mean.
  At 1024x2048 (what users light scenes with) the map is 25 MB, and its
  importance tables two (1024, 2049) f32 CDFs of ~8 MB each.
- ``quadric_env``: a matte ground disk of radius 20, an upright matte
  cylinder of radius 0.4 and height 2 clipped to phi_max 270 degrees, a
  mirror sphere of radius 0.6 and a matte box of 12 triangles, lit by an
  annulus area light (radii 0.2 and 0.5, L = 20) facing down through
  reverse_orientation, a thin cylinder area light (radius 0.05, length
  1.5, L = (8, 4, 2)) and the sky as an infinite light, turned by
  SKY_TO_WORLD; a perspective camera at fov 40.  It renders at BASELINE
  config 2's width, 256x256 at 64 spp.
- ``statue_env``: the statue of ``scene/bigscene.py`` under the same sky.

Each returns (scene, camera) on `device`.  ``build`` makes the calls on a
builder it is given, so the JAX package's SceneBuilder, which takes the
same calls, builds the same tables from the same map.  To render one on
the card::

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.tools import env_scenes

    scene, camera = env_scenes.quadric_env()
    img = rdr.render(scene, camera, rdr.RenderCfg("path", 64, 5, 1.0),
                     smpl.make_sampler(smpl.SOBOL, 64, camera.resolution))

(``integrator`` "ao" takes ``extra=dict(n_samples=64)``; pass
``device="cpu"`` and a small resolution and ``sky_hw`` to render on the
CPU.)
"""

from __future__ import annotations

import numpy as np

from ..models import cameras as cam
from ..scene import bigscene
from ..scene.builder import SceneBuilder
from ..utils import transform as tr

RESOLUTION = (256, 256)
SKY_HW = (1024, 2048)
SUN_RADIUS_DEG = 0.5
SUN_GAIN = 5000.0  # the sun's radiance over the sky's mean
SUN_THETA_PHI = (np.deg2rad(50.0), 0.7)  # in the map's light space, +z up
ZENITH = np.array([0.22, 0.40, 0.85])
HORIZON = np.array([0.85, 0.88, 0.92])
GROUND = np.array([0.12, 0.10, 0.08])
# light space (+z up) to world (+y up), turned 30 degrees about y
_YAW = np.deg2rad(30.0)
SKY_TO_WORLD = tr.from_matrix(np.array([
    [np.cos(_YAW), np.sin(_YAW), 0.0, 0.0],
    [0.0, 0.0, 1.0, 0.0],
    [-np.sin(_YAW), np.cos(_YAW), 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0]]))
# object +z up (world +y): the ground disk and the upright cylinder
_Z_UP = np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]])
# object +z along world +x: the lamp cylinder
_Z_ALONG_X = np.array([[0.0, 0, 1], [1, 0, 0], [0, 1, 0]])
CAMERA = ([0.0, 1.5, 5.5], [0.0, 0.8, 0.0], [0.0, 1.0, 0.0], 40.0)  # eye, look, up, fov


def _placed(rot, at) -> tr.Transform:
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = rot, at
    return tr.from_matrix(m)


def sky_map(h: int = SKY_HW[0], w: int = SKY_HW[1], seed: int = 0) -> np.ndarray:
    """(h, w, 3) f32 equirect radiance, row i at theta (i + 0.5) pi / h from
    +z, column j at phi (j + 0.5) 2 pi / w (see the module's docstring).
    The sun covers every texel within SUN_RADIUS_DEG of its direction and
    at least the nearest one."""
    rng = np.random.default_rng(seed)
    theta = (np.arange(h) + 0.5) * np.pi / h
    phi = (np.arange(w) + 0.5) * 2.0 * np.pi / w
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    dirs = np.stack(np.broadcast_arrays(st * np.cos(phi), st * np.sin(phi), ct), -1)
    # brighter toward the horizon above it, a dim ground below
    g = (1.0 - np.clip(ct, 0.0, 1.0)) ** 3
    sky = ZENITH * (1.0 - g[..., None]) + HORIZON * g[..., None]
    sky = np.where((ct > 0.0)[..., None], sky, GROUND)
    # clouds: a few octaves of random plane waves over the sphere
    noise = np.zeros((h, w))
    amp, freq = 1.0, 2.0
    for _ in range(4):
        k = rng.normal(size=(3, 3)) * freq
        ph = rng.uniform(0.0, 2.0 * np.pi, 3)
        noise += amp * np.cos(dirs @ k.T + ph).sum(-1) / 3.0
        amp, freq = amp * 0.5, freq * 2.0
    cloud = np.clip(1.5 * (noise - 0.1), 0.0, 1.0) * np.clip(4.0 * ct, 0.0, 1.0)
    sky = sky * (1.0 - 0.7 * cloud[..., None]) + 0.9 * cloud[..., None]
    # the sun
    s_theta, s_phi = SUN_THETA_PHI
    sun_dir = np.array([np.sin(s_theta) * np.cos(s_phi), np.sin(s_theta) * np.sin(s_phi),
                        np.cos(s_theta)])
    cos_ang = dirs @ sun_dir
    in_sun = cos_ang >= np.cos(np.deg2rad(SUN_RADIUS_DEG))
    in_sun.flat[np.argmax(cos_ang)] = True
    sky[in_sun] = SUN_GAIN * sky.mean() * np.array([1.0, 0.95, 0.85])
    return sky.astype(np.float32)


def box_mesh(lo, hi):
    """(indices (12, 3), positions (8, 3)) of the box lo..hi, every
    triangle wound so its normal points out."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    pos = np.array([[(hi if i >> k & 1 else lo)[k] for k in range(3)] for i in range(8)])
    quads = [(0, 4, 6, 2), (1, 3, 7, 5), (0, 1, 5, 4), (2, 6, 7, 3), (0, 2, 3, 1), (4, 5, 7, 6)]
    centre = 0.5 * (lo + hi)
    idx = []
    for a, b, c, d in quads:
        for tri in ((a, b, c), (a, c, d)):
            p0, p1, p2 = pos[list(tri)]
            if np.dot(np.cross(p1 - p0, p2 - p0), p0 - centre) < 0.0:
                tri = tri[::-1]
            idx.append(tri)
    return np.asarray(idx, np.int32), pos.astype(np.float32)


def add_sky(b, sky):
    """The sky map as b's infinite light, turned by SKY_TO_WORLD."""
    return b.add_infinite_light(radiance_map=sky, light_to_world=SKY_TO_WORLD)


def build(b, sky):
    """quadric_env's calls on builder b (this package's SceneBuilder or one
    with its calls) under the map `sky`.  Returns b."""
    ground = b.add_matte(kd=(0.5, 0.5, 0.5))
    clay = b.add_matte(kd=(0.6, 0.45, 0.3))
    mirror = b.add_mirror(kr=(0.9, 0.9, 0.9))
    blue = b.add_matte(kd=(0.2, 0.3, 0.6))
    dark = b.add_matte(kd=(0.0, 0.0, 0.0))
    b.add_disk(_placed(_Z_UP, (0.0, 0.0, 0.0)), radius=20.0, material=ground)
    b.add_cylinder(_placed(_Z_UP, (-1.2, 0.0, -0.4)), radius=0.4, z_min=0.0, z_max=2.0,
                   phi_max=270.0, material=clay)
    b.add_sphere(tr.translate([1.1, 0.6, 0.3]), radius=0.6, material=mirror)
    idx, pos = box_mesh((-0.1, 0.0, 0.6), (0.6, 0.7, 1.3))
    b.add_triangle_mesh(idx, pos, material=blue)
    b.add_disk(_placed(_Z_UP, (0.0, 3.2, 0.0)), radius=0.5, inner_radius=0.2, material=dark,
               area_light=dict(L=(20.0, 20.0, 20.0)), reverse_orientation=True)
    b.add_cylinder(_placed(_Z_ALONG_X, (0.0, 2.3, 1.6)), radius=0.05, z_min=-0.75, z_max=0.75,
                   material=dark, area_light=dict(L=(8.0, 4.0, 2.0)))
    add_sky(b, sky)
    return b


def camera(resolution=RESOLUTION, device="cuda"):
    """CAMERA's perspective camera."""
    eye, look, up, fov = CAMERA
    return cam.make_perspective(tr.look_at(eye, look, up), resolution, fov=fov, device=device)


def quadric_env(resolution=RESOLUTION, sky_hw=SKY_HW, device="cuda"):
    """The slice's scene (see the module's docstring): (scene, camera)."""
    b = build(SceneBuilder(), sky_map(*sky_hw))
    return b.finalize(device), camera(resolution, device)


def statue_env(resolution=(1024, 1024), subdivisions: int = 8, sky_hw=SKY_HW, device="cuda"):
    """bigscene's statue (statue_build) under the sky: (scene, camera)."""
    b = bigscene.statue_build(SceneBuilder(), subdivisions)
    add_sky(b, sky_map(*sky_hw))
    return b.finalize(device), bigscene.statue_camera(resolution, device)
