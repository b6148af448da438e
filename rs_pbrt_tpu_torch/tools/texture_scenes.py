"""Scenes of textures, MIP-mapped image maps, bump maps, alpha masks and
the projection and goniometric lights.

- ``texture_grid``: at BASELINE config 2's width (256x256), a floor quad
  whose matte kd is a checker of an image map (a seeded 1000x750 RGB
  image: its Lanczos resample to 1024x1024 and a 10-level pyramid,
  filtered by the camera rays' footprints) and an fbm; nine spheres, each
  binding other slots and families: a marble kd on plastic with a scale
  texture's ks; wrinkled roughness (u and v) on metal; a windy kd on
  Oren-Nayar matte whose sigma is an fbm; a dots kd (bilerp and constant
  children); a uv kd on substrate; a mix kd (marble and windy) on uber
  with a wrinkled opacity; a bump-mapped (fbm) matte; glass with a uv kt;
  a mirror with a scaled kr.  A vertical quad cut by a checker alpha mask,
  and a horizontal quad between the area light and the floor whose
  checker shadow-alpha mask cuts only its shadow.  Lit by a quad area
  light, a projection light and a goniometric light, their images seeded.
  The JAX package gives these two lights power 1e-9, so selection by
  power (path, volpath, directlighting "one", SPPM's photons) almost
  never picks them: renders reach them through whitted and
  directlighting "all", which sample every light.
- ``statue_marble``: ``scene/bigscene.py``'s statue in a plastic with a
  marble kd and an fbm bump map and no image map, so that its renders
  regenerate paths (``regen.eligible``).

``build`` and ``statue_marble_build`` make the calls on a builder they are
given, so the JAX package's SceneBuilder, which takes the same calls,
builds the same tables.  Each scene function returns (scene, camera) on
`device`; pass ``device="cpu"`` and a small resolution to render on the
CPU.
"""

from __future__ import annotations

import numpy as np

from ..models import cameras as cam
from ..ops import texture as tx
from ..scene import arrays as sa
from ..scene import bigscene
from ..scene.builder import SceneBuilder
from ..utils import transform as tr
from .material_scenes import ground_mesh

RESOLUTION = (256, 256)
IMAGE_HW = (750, 1000)  # the floor's image: not a power of two
CAMERA = ([0.0, 3.2, 6.0], [0.0, 0.3, 0.0], [0.0, 1.0, 0.0], 45.0)  # eye, look, up, fov
SPHERE_RADIUS = 0.45
SPHERES = ((-1.3, -1.2), (0.0, -1.2), (1.3, -1.2), (-1.3, 0.0), (0.0, 0.0), (1.3, 0.0),
           (-1.3, 1.2), (0.0, 1.2), (1.3, 1.2))  # (x, z) of each sphere's centre


def seeded_image(hw, seed: int) -> np.ndarray:
    """An (H, W, 3) RGB image from seed: smooth colour bands and stripes
    with per-texel noise, values in [0, 1]."""
    rng = np.random.default_rng(seed)
    h, w = hw
    y, x = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    freq = rng.uniform(2, 9, (3, 2))
    phase = rng.uniform(0, 2 * np.pi, 3)
    bands = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (fx * x + fy * y) + ph)
                      for (fx, fy), ph in zip(freq, phase)], -1)
    stripes = (np.floor(x * rng.integers(5, 15)) % 2)[..., None] * 0.3
    img = 0.6 * bands + stripes + 0.1 * rng.random((h, w, 3))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _sphere(b, x, z, material):
    b.add_sphere(tr.translate([x, SPHERE_RADIUS, z]), radius=SPHERE_RADIUS, material=material)


def _quad(b, corners, material, **kw):
    """Two triangles over the four corners, uv (0,0), (1,0), (1,1), (0,1)."""
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], corners, uvs=[[0, 0], [1, 0], [1, 1], [0, 1]],
                        material=material, **kw)


def build(b, image_hw=IMAGE_HW, seed: int = 0):
    """texture_grid's calls on builder b (this package's SceneBuilder or one
    with its calls), its images made from seed; the floor's image at
    image_hw.  Returns b."""
    T = tx
    c = lambda rgb: b.add_texture(T.TEX_CONSTANT, params={T.TP_VALUE: rgb})
    noise_xf = tr.scale(0.5, 0.5, 0.5)  # its inverse scales world points by 2
    image = b.add_texture(T.TEX_IMAGEMAP, params={T.TP_WRAP: 0, T.TP_GAMMA_SCALE: 0.9},
                          image=seeded_image(image_hw, seed))
    fbm = b.add_texture(T.TEX_FBM, params={T.TP_VALUE: (0.6, 0.55, 0.5), T.TP_OCTAVES: 6,
                                           T.TP_OMEGA: 0.55}, world_to_texture=noise_xf)
    checker = b.add_texture(T.TEX_CHECKER, params={T.TP_SU: 6.0, T.TP_SV: 6.0},
                            children=(image, fbm))
    marble = b.add_texture(T.TEX_MARBLE, params={T.TP_SCALE_N: 2.5, T.TP_VARIATION: 0.6,
                                                 T.TP_OCTAVES: 8, T.TP_OMEGA: 0.5})
    wrinkled = b.add_texture(T.TEX_WRINKLED, params={T.TP_VALUE: (0.3, 0.3, 0.3),
                                                     T.TP_OCTAVES: 5, T.TP_OMEGA: 0.5},
                             world_to_texture=noise_xf)
    windy = b.add_texture(T.TEX_WINDY, params={T.TP_VALUE: (0.7, 0.6, 0.4)},
                          world_to_texture=tr.scale(0.25, 0.25, 0.25))
    dots = b.add_texture(T.TEX_DOTS, params={T.TP_SU: 8.0, T.TP_SV: 4.0},
                         children=(b.add_texture(T.TEX_BILERP, params={T.TP_VALUE: (0.8, 0.2,
                                                                                     0.1)}),
                                   c((0.1, 0.3, 0.7))))
    uv = b.add_texture(T.TEX_UV, params={T.TP_SU: 2.0, T.TP_SV: 3.0, T.TP_DU: 0.25})
    scale = b.add_texture(T.TEX_SCALE, children=(uv, c((0.5, 0.5, 0.5))))
    mix = b.add_texture(T.TEX_MIX, params={T.TP_VALUE: 0.4}, children=(marble, windy))
    sigma = b.add_texture(T.TEX_FBM, params={T.TP_VALUE: (40.0, 40.0, 40.0), T.TP_OCTAVES: 4})
    bump = b.add_texture(T.TEX_FBM, params={T.TP_VALUE: (0.04, 0.04, 0.04), T.TP_OCTAVES: 5},
                         world_to_texture=tr.scale(0.2, 0.2, 0.2))
    alpha = b.add_texture(T.TEX_CHECKER, params={T.TP_SU: 4.0, T.TP_SV: 4.0},
                          children=(c((1.0, 1.0, 1.0)), c((0.0, 0.0, 0.0))))
    salpha = b.add_texture(T.TEX_CHECKER, params={T.TP_SU: 3.0, T.TP_SV: 3.0},
                           children=(c((0.0, 0.0, 0.0)), c((1.0, 1.0, 1.0))))

    def textured(mat, **slots):
        for slot, tex in slots.items():
            b.set_material_texture(mat, getattr(sa, "TEX_SLOT_" + slot.upper()), tex)
        return mat

    floor = textured(b.add_matte(kd=(0.5, 0.5, 0.5)), kd=checker)
    mats = [
        textured(b.add_plastic(kd=(0.3, 0.3, 0.3), ks=(0.3, 0.3, 0.3), roughness=0.1),
                 kd=marble, ks=scale),
        textured(b.add_metal(roughness=0.05), rough_u=wrinkled, rough_v=wrinkled),
        textured(b.add_matte(kd=(0.5, 0.5, 0.5), sigma=10.0), kd=windy, sigma=sigma),
        textured(b.add_matte(), kd=dots),
        textured(b.add_substrate(kd=(0.5, 0.5, 0.5), ks=(0.05, 0.05, 0.05), roughness=0.1),
                 kd=uv),
        textured(b.add_uber(kd=(0.4, 0.4, 0.4), ks=(0.1, 0.1, 0.1), roughness=0.1,
                            opacity=(1.0, 1.0, 1.0)), kd=mix, opacity=wrinkled),
        textured(b.add_matte(kd=(0.7, 0.7, 0.65)), bump=bump),
        textured(b.add_glass(), kt=uv),
        textured(b.add_mirror(), kr=scale),
    ]
    for (x, z), mat in zip(SPHERES, mats):
        _sphere(b, x, z, mat)
    # the floor's uv: (x, z) over its 12 units, so the checker's cells are 2 units
    idx, pos = ground_mesh(6.0, 1)
    b.add_triangle_mesh(idx, pos, uvs=(pos[:, [0, 2]] + 6.0) / 12.0, material=floor)
    plain = b.add_matte(kd=(0.6, 0.6, 0.6))
    _quad(b, [[-2.6, 0.0, 0.9], [-1.9, 0.0, 0.9], [-1.9, 1.2, 0.9], [-2.6, 1.2, 0.9]], plain,
          alpha_tex=alpha)
    _quad(b, [[0.5, 2.2, -0.5], [1.7, 2.2, -0.5], [1.7, 2.2, 0.7], [0.5, 2.2, 0.7]], plain,
          shadow_alpha_tex=salpha)
    dark = b.add_matte(kd=(0.0, 0.0, 0.0))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-1.0, 4.5, -1.5], [1.0, 4.5, -1.5], [1.0, 4.5, 0.5], [-1.0, 4.5, 0.5]],
                        material=dark, area_light=dict(L=(7.0, 6.5, 6.0)))
    b.add_projection_light(p=(-3.0, 3.5, 3.0), to=(0.0, 0.0, 0.0), I=(30.0, 30.0, 30.0),
                           fov=40.0, image=seeded_image((64, 64), seed + 1))
    b.add_gonio_light(p=(3.0, 3.0, 2.0), to=(0.0, -1.0, 0.0), I=(12.0, 12.0, 12.0),
                      image=seeded_image((32, 64), seed + 2))
    return b


def camera(resolution=RESOLUTION, device="cuda"):
    """CAMERA's perspective camera."""
    eye, look, up, fov = CAMERA
    return cam.make_perspective(tr.look_at(eye, look, up), resolution, fov=fov, device=device)


def texture_grid(resolution=RESOLUTION, image_hw=IMAGE_HW, device="cuda"):
    """The slice's scene (see the module's docstring): (scene, camera)."""
    return build(SceneBuilder(), image_hw).finalize(device), camera(resolution, device)


def statue_marble_build(b, subdivisions: int = 8):
    """The statue's calls on builder b with its material (statue_build's
    first, id 1) made a plastic with a marble kd and an fbm bump map.
    Returns b."""
    bigscene.statue_build(b, subdivisions)
    plastic = b.add_plastic(kd=(0.5, 0.5, 0.5), ks=(0.25, 0.25, 0.25), roughness=0.08)
    marble = b.add_texture(tx.TEX_MARBLE, params={tx.TP_SCALE_N: 1.5, tx.TP_VARIATION: 0.5,
                                                  tx.TP_OCTAVES: 8, tx.TP_OMEGA: 0.5})
    bump = b.add_texture(tx.TEX_FBM, params={tx.TP_VALUE: (0.02, 0.02, 0.02), tx.TP_OCTAVES: 4},
                         world_to_texture=tr.scale(0.1, 0.1, 0.1))
    b.set_material_texture(plastic, sa.TEX_SLOT_KD, marble)
    b.set_material_texture(plastic, sa.TEX_SLOT_BUMP, bump)
    b.mats[1] = b.mats[plastic]
    return b


def statue_marble(resolution=(1024, 1024), subdivisions: int = 8, device="cuda"):
    """(scene, camera): statue_marble_build's scene on `device`."""
    scene = statue_marble_build(SceneBuilder(), subdivisions).finalize(device)
    return scene, bigscene.statue_camera(resolution, device)
