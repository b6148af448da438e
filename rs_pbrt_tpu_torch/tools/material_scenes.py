"""Scenes of the other BxDFs: plastic, metal, substrate, uber, translucent,
Disney, mix and Fourier.

- ``glossy_fourier_table``: a SCATFUN-layout table (the dict
  ``ops/fourier_bsdf.read_bsdf_file`` returns: mu, cdf, a_offset, m, a,
  eta, n_channels, m_max) made by numpy: a Lambertian base plus a
  normalized Phong lobe of exponent PHONG_EXPONENT about the mirror
  direction, so that orders up to ~48 matter near grazing.  Each (mu_o,
  mu_i) cell of a reflection (mu_i mu_o < 0, incident directions negated)
  stores f |mu_i| projected on cos(k phi) over PHI_SAMPLES azimuths, phi
  the angle between -wi and wo (the JAX ``_cos_d_phi(-wi, wo)``), in the
  channels Y, R, B; orders whose coefficient is below ORDER_EPS of the
  cell's first are cut.  The cdf rows integrate a0 along mu_i
  (``ops/bssrdf.integrate_catmull_rom``).  At 64 nodes its dense repack is
  4096 x 192 f32, 3.1 MB.  It is scene data standing in for pbrt's
  measured ``.bsdf`` files, which the repository does not hold.
- ``material_grid``: at BASELINE config 2's width (256x256), nine spheres
  and one 12-triangle box on a 2-triangle matte ground, one each of:
  plastic; copper metal; substrate; uber with kd, ks, kr, kt and opacity
  0.7 (all five lobe slots); translucent; Disney with clearcoat and sheen;
  Disney with spec_trans; thin Disney with diffTrans and flatness;
  mix(plastic, metal); Fourier on the glossy table.  Lit by a 2-triangle
  area light and by ``env_scenes.sky_map`` (1024x2048) as the infinite
  light; a perspective camera.
- ``statue_disney``: ``scene/bigscene.py``'s statue (the same triangles as
  its statue_build) in a Disney material with clearcoat and sheen, so that
  a render shades lobe slots 0-3 on every statue hit.

``build`` and ``statue_disney_build`` make the calls on a builder they are
given, so the JAX package's SceneBuilder, which takes the same calls,
builds the same tables.  Each scene function returns (scene, camera) on
`device`; pass ``device="cpu"``, a small resolution and ``sky_hw`` to
render on the CPU.
"""

from __future__ import annotations

import numpy as np

from ..models import cameras as cam
from ..ops import bssrdf as bss
from ..ops import fourier_bsdf as fb
from ..scene import bigscene
from ..scene.builder import SceneBuilder
from ..utils import transform as tr
from . import env_scenes

RESOLUTION = (256, 256)
PHONG_EXPONENT = 200.0
GLOSSY_KD = (0.30, 0.18, 0.08)  # the Lambertian base, rgb
GLOSSY_KS = 0.6  # the Phong lobe's albedo at normal incidence
PHI_SAMPLES = 1024
ORDER_EPS = 1e-5
LUMA = (0.212671, 0.715160, 0.072169)
CAMERA = ([0.0, 3.0, 5.6], [0.3, 0.35, 0.0], [0.0, 1.0, 0.0], 42.0)  # eye, look, up, fov
SPHERE_RADIUS = 0.45
SPHERES = ((-1.3, -1.2), (0.0, -1.2), (1.3, -1.2), (-1.3, 0.0), (0.0, 0.0), (1.3, 0.0),
           (-1.3, 1.2), (0.0, 1.2), (1.3, 1.2))  # (x, z) of each sphere's centre


def glossy_brdf(mu_i, mu_o, cos_phi):
    """The glossy table's BRDF, rgb (..., 3), at the table's coordinates:
    mu_i = -wi.z, mu_o = wo.z, cos_phi the cosine of the azimuth between
    -wi and wo; 0 where mu_i mu_o >= 0 (transmission)."""
    mu_i, mu_o, cos_phi = np.broadcast_arrays(*(np.asarray(x, np.float64)
                                                for x in (mu_i, mu_o, cos_phi)))
    s = np.sqrt(np.clip(1.0 - mu_i * mu_i, 0.0, 1.0) * np.clip(1.0 - mu_o * mu_o, 0.0, 1.0))
    # the cosine between wi and wo's mirror direction
    cos_a = s * cos_phi - mu_i * mu_o
    lobe = GLOSSY_KS * (PHONG_EXPONENT + 2.0) / (2.0 * np.pi) * np.clip(cos_a, 0.0, 1.0) \
        ** PHONG_EXPONENT
    f = np.asarray(GLOSSY_KD) / np.pi + lobe[..., None]
    return np.where(((mu_i * mu_o) < 0.0)[..., None], f, 0.0)


def glossy_fourier_table(n_mu: int = 64, seed: int = 0) -> dict:
    """The glossy SCATFUN-layout table (see the module's docstring) on
    n_mu nodes in mu: -1, 1 and n_mu - 2 nodes between, spaced by cosine
    with a jitter drawn from seed (no node at 0)."""
    rng = np.random.default_rng(seed)
    k = np.arange(n_mu, dtype=np.float64)
    nodes = -np.cos(np.pi * (k + 0.5 + rng.uniform(-0.2, 0.2, n_mu)) / n_mu)
    nodes[0], nodes[-1] = -1.0, 1.0
    mu = np.sort(nodes).astype(np.float32)
    phi = (np.arange(PHI_SAMPLES) + 0.5) * np.pi / PHI_SAMPLES
    cos_k = np.cos(np.outer(phi, np.arange(fb.M_CAP)))  # (PHI, M_CAP)
    mo, mi = np.meshgrid(mu.astype(np.float64), mu.astype(np.float64), indexing="ij")
    g = glossy_brdf(mi[..., None], mo[..., None], np.cos(phi)) * np.abs(mi)[..., None, None]
    # f |mu_i| = sum_k a_k cos(k phi): a_0 the mean over [0, pi], a_k twice
    # the mean of its product with cos(k phi)
    rgb = np.einsum("oipc,pk->oick", g, cos_k) / PHI_SAMPLES
    rgb[..., 1:] *= 2.0
    y = np.einsum("oick,c->oik", rgb, np.asarray(LUMA))
    series = np.stack([y, rgb[..., 0, :], rgb[..., 2, :]], 2).reshape(n_mu * n_mu, 3, fb.M_CAP)
    refl = (mi * mo < 0.0).reshape(-1)
    big = np.abs(series[:, 0]) > ORDER_EPS * np.abs(series[:, 0, :1])
    m = np.where(refl & big.any(1), fb.M_CAP - np.argmax(big[:, ::-1], axis=1), 0)
    m = np.where(refl, np.maximum(m, 1), 0).astype(np.int32)
    offsets, a = np.zeros(n_mu * n_mu, np.int32), []
    at = 0
    for c in range(n_mu * n_mu):
        offsets[c] = at
        if m[c]:
            a.append(series[c, :, :m[c]].reshape(-1))
            at += 3 * int(m[c])
    a0 = np.where(refl, series[:, 0, 0], 0.0).reshape(n_mu, n_mu)
    cdf, _ = bss.integrate_catmull_rom(mu.astype(np.float64), a0)
    return dict(mu=mu, cdf=cdf.astype(np.float32), a_offset=offsets, m=m,
                a=np.concatenate(a).astype(np.float32), eta=1.0, n_channels=3,
                m_max=int(m.max()))


def _sphere(b, x, z, material):
    b.add_sphere(tr.translate([x, SPHERE_RADIUS, z]), radius=SPHERE_RADIUS, material=material)


def ground_mesh(half: float, cells: int):
    """(indices, positions) of the square ground y = 0 of half-width half
    in cells x cells quads, 2 triangles each, normals up."""
    t = np.linspace(-half, half, cells + 1)
    xs, zs = np.meshgrid(t, t, indexing="ij")
    pos = np.stack([xs.ravel(), np.zeros(xs.size), zs.ravel()], -1).astype(np.float32)
    i, j = np.meshgrid(np.arange(cells), np.arange(cells), indexing="ij")
    a = (i * (cells + 1) + j).ravel()
    b, c, d = a + 1, a + cells + 2, a + cells + 1
    idx = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)])
    return idx.astype(np.int32), pos


def build(b, sky, fourier_table: dict, ground_cells: int = 1):
    """material_grid's calls on builder b (this package's SceneBuilder or
    one with its calls) under the map `sky`, the Fourier material on
    `fourier_table` (a dense table, ``fourier_bsdf.make_fourier_table``'s
    dict); the ground in ground_cells^2 quads (48 gives 4,608 triangles,
    above scene_intersect.BRUTE_FORCE_MAX_TRIS, so build_accel makes a
    BVH).  Returns b."""
    ground = b.add_matte(kd=(0.45, 0.45, 0.42))
    dark = b.add_matte(kd=(0.0, 0.0, 0.0))
    plastic = b.add_plastic(kd=(0.1, 0.25, 0.6), ks=(0.4, 0.4, 0.4), roughness=0.08)
    metal = b.add_metal(roughness=0.05)
    mats = [
        plastic,
        metal,
        b.add_substrate(kd=(0.55, 0.2, 0.15), ks=(0.06, 0.06, 0.06), roughness=0.12),
        b.add_uber(kd=(0.3, 0.5, 0.2), ks=(0.2, 0.2, 0.2), kr=(0.3, 0.3, 0.3),
                   kt=(0.4, 0.4, 0.4), roughness=0.1, eta=1.4, opacity=(0.7, 0.7, 0.7)),
        b.add_translucent(kd=(0.6, 0.5, 0.3), reflect=(0.5, 0.5, 0.5),
                          transmit=(0.4, 0.45, 0.5)),
        b.add_disney(color=(0.7, 0.2, 0.15), metallic=0.1, roughness=0.4, sheen=0.8,
                     clearcoat=0.9, clearcoat_gloss=0.8, sheen_tint=0.4, anisotropic=0.3),
        b.add_disney(color=(0.9, 0.9, 0.95), roughness=0.15, spec_trans=0.8, eta=1.45),
        b.add_disney(color=(0.3, 0.7, 0.35), roughness=0.6, thin=True, diff_trans=0.7,
                     flatness=0.5),
        b.add_mix(plastic, metal, amount=(0.35, 0.5, 0.65)),
    ]
    fourier = b.add_fourier(table=fourier_table)
    for (x, z), mat in zip(SPHERES, mats):
        _sphere(b, x, z, mat)
    idx, pos = env_scenes.box_mesh((2.15, 0.0, -0.35), (2.85, 0.7, 0.35))
    b.add_triangle_mesh(idx, pos, material=fourier)
    b.add_triangle_mesh(*ground_mesh(6.0, ground_cells), material=ground)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-1.0, 4.5, -1.5], [1.0, 4.5, -1.5], [1.0, 4.5, 0.5], [-1.0, 4.5, 0.5]],
                        material=dark, area_light=dict(L=(9.0, 8.5, 8.0)))
    env_scenes.add_sky(b, sky)
    return b


def camera(resolution=RESOLUTION, device="cuda"):
    """CAMERA's perspective camera."""
    eye, look, up, fov = CAMERA
    return cam.make_perspective(tr.look_at(eye, look, up), resolution, fov=fov, device=device)


def material_grid(resolution=RESOLUTION, sky_hw=env_scenes.SKY_HW, n_mu: int = 64,
                  device="cuda"):
    """The slice's scene (see the module's docstring): (scene, camera)."""
    table = fb.make_fourier_table(glossy_fourier_table(n_mu))
    b = build(SceneBuilder(), env_scenes.sky_map(*sky_hw), table)
    return b.finalize(device), camera(resolution, device)


def statue_disney_build(b, subdivisions: int = 8):
    """The statue's calls on builder b with its material (statue_build's
    first, id 1) made a Disney material with clearcoat and sheen.  Returns
    b."""
    bigscene.statue_build(b, subdivisions)
    disney = b.add_disney(color=(0.55, 0.42, 0.3), metallic=0.2, roughness=0.35, sheen=0.6,
                          clearcoat=0.8, clearcoat_gloss=0.9)
    b.mats[1] = b.mats[disney]
    return b


def statue_disney(resolution=(1024, 1024), subdivisions: int = 8, device="cuda"):
    """(scene, camera): statue_disney_build's scene on `device`."""
    scene = statue_disney_build(SceneBuilder(), subdivisions).finalize(device)
    return scene, bigscene.statue_camera(resolution, device)
