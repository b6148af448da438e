"""Flat scene tables: the column layout and the Scene of torch tensors.

The layout (column constants) is the JAX package's ``scene/arrays.py``,
kept here as the port's own copy.  The Scene holds only what the ported
paths read: the packed triangle, quadric, material and light tables, the
light-pick power and the per-light triangle-area CDF, the media (a
homogeneous table and the density grids) and the subsurface materials'
folded BSSRDF profiles, the infinite light's map, transforms and
importance, the Fourier BSDF's table, plus the counts and feature flags
that decide
which route a scene may take (``ops/path_kernel.mega_cfg``) and which
parts the port refuses.  A primitive's media are its inside and outside
medium ids, columns TA_MED_IN/OUT of tri_attr and SP_MED_IN/OUT of
sph_attr (-1: vacuum).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..device import resolve
from ..ops import sampling as smp

# material type tags
MATTE = 0
PLASTIC = 1
MIRROR = 2
GLASS = 3
METAL = 4
SUBSTRATE = 5
UBER = 6
TRANSLUCENT = 7
FOURIER = 8
DISNEY = 9
HAIR = 10
MIXMAT = 11
SUBSURFACE = 12
N_MATERIAL_TYPES = 13

# material parameter vector layout (mat_params[:, k])
MP_KD = 0  # 0:3 diffuse rgb
MP_KS = 3
MP_KR = 6
MP_KT = 9
MP_ROUGH_U = 12
MP_ROUGH_V = 13
MP_ETA = 14
MP_SIGMA = 15  # oren-nayar sigma (degrees)
MP_REMAP_ROUGH = 16
MP_ETA3 = 17
MP_K3 = 20
MP_OPACITY = 23
MP_BSSRDF = 26
N_MAT_PARAMS = 27
# the hair material's use of the slots (JAX builder.add_hair): MP_KD holds
# sigma_a, or the color when MP_HAIR_MODE is 1; beta_m, beta_n, alpha
# (degrees) and eta
MP_HAIR_BETA_M = MP_ROUGH_U
MP_HAIR_BETA_N = MP_ROUGH_V
MP_HAIR_ALPHA = MP_SIGMA
MP_HAIR_MODE = MP_OPACITY

N_TEX_SLOTS = 9

# light type tags
LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_PROJECTION = 3
LIGHT_GONIO = 4
LIGHT_AREA = 5
LIGHT_INFINITE = 6

# light flags
LF_DELTA_POSITION = 1
LF_DELTA_DIRECTION = 2
LF_AREA = 4
LF_INFINITE = 8

# light parameter layout
LP_P = 0
LP_I = 3  # 3:6 radiance rgb (premultiplied by scale)
LP_COS_TOTAL = 6
LP_COS_FALLOFF = 7
LP_WORLD_RADIUS = 8
LP_WORLD_CENTER = 9  # 9:12
LP_TWO_SIDED = 12
LP_AREA = 13  # total emitting area of the light's shape
LP_TEX = 14
LP_TAN_FOV = 15
N_LIGHT_PARAMS = 16

# area-light geometry kinds
ALG_NONE = 0
ALG_TRI_RANGE = 1  # triangles [tri_start, tri_end)
ALG_SPHERE = 2
ALG_CYLINDER = 3
ALG_DISK = 4

# quadric (sph_*) kinds; params per kind: SPHERE and CYLINDER radius,
# z_min, z_max, phi_max; DISK radius, inner_radius, height, phi_max
QK_SPHERE = 0
QK_CYLINDER = 1
QK_DISK = 2

# sph_attr columns
SP_O2W = 0  # 16 (row-major 4x4)
SP_W2O = 16
SP_PARAMS = 32  # 4 params (per-kind layout above)
SP_MAT = 36
SP_LIGHT = 37
SP_REVERSE = 38
SP_MED_IN = 39
SP_MED_OUT = 40
SP_KIND = 41
N_SPH_ATTR = 42

# tri_attr columns
TA_P0 = 0
TA_P1 = 3
TA_P2 = 6
TA_N0 = 9
TA_N1 = 12
TA_N2 = 15
TA_UV0 = 18
TA_UV1 = 20
TA_UV2 = 22
TA_HAS_N = 24
TA_MAT = 25
TA_LIGHT = 26
TA_REVERSE = 27
TA_MED_IN = 28
TA_MED_OUT = 29
TA_ALPHA = 30
TA_SALPHA = 31
N_TRI_ATTR = 32

# crv_attr columns: a flattened curve segment (the JAX package's
# ops/curves.py CV_* layout)
CV_CP = 0  # 0:12 four control points (world space)
CV_W0 = 12  # width at u0
CV_W1 = 13  # width at u1
CV_U0 = 14  # the parent curve's parameter at the segment's start
CV_U1 = 15
CV_N0 = 16  # 16:19 ribbon normal at u0
CV_N1 = 19  # 19:22 ribbon normal at u1
CV_NORM_ANGLE = 22  # angle between n0 and n1 (the ribbon slerp)
CV_INV_SIN_NA = 23  # 1 / sin(norm_angle), 0 where degenerate
CV_TYPE = 24  # 0 flat, 1 cylinder, 2 ribbon
CV_MAT = 25
N_CURVE_ATTR = 26

# mat_attr columns
MA_TYPE = 0
MA_PARAMS = 1  # 1 : 1+N_MAT_PARAMS
MA_TEX = 1 + N_MAT_PARAMS
N_MAT_ATTR = 1 + N_MAT_PARAMS + N_TEX_SLOTS

# light_attr columns: light params in 0:N_LIGHT_PARAMS, then ints as floats
LA_TYPE = N_LIGHT_PARAMS
LA_FLAGS = N_LIGHT_PARAMS + 1
LA_GEOM = N_LIGHT_PARAMS + 2
LA_TRI_START = N_LIGHT_PARAMS + 3
LA_TRI_END = N_LIGHT_PARAMS + 4
LA_SHAPE_IDX = N_LIGHT_PARAMS + 5
N_LIGHT_ATTR = N_LIGHT_PARAMS + 6


@dataclass
class Scene:
    tri_attr: torch.Tensor  # (max(T,1), N_TRI_ATTR) f32
    mat_attr: torch.Tensor  # (M, N_MAT_ATTR) f32
    light_attr: torch.Tensor  # (max(L,1), N_LIGHT_ATTR) f32
    light_power: torch.Tensor  # (L,) f32 light-pick power
    alight_tri_cdf: torch.Tensor  # (L, A+1) per-light triangle-area CDF
    world_center: torch.Tensor  # (3,)
    world_radius: float
    n_tris: int
    n_lights: int
    sph_attr: torch.Tensor = None  # (max(S,1), N_SPH_ATTR) f32
    n_spheres: int = 0  # quadrics of every kind (the JAX package's sph_* family)
    quad_kind_mask: int = 0  # bit QK_* set when a quadric of that kind exists
    light_type_mask: int = 0  # bit LIGHT_* set when such a light exists
    has_sphere_lights: bool = False  # an area light on a sphere (ALG_SPHERE)
    has_quadric_lights: bool = False  # an area light on a disk or cylinder
    crv_attr: torch.Tensor = None  # (C, N_CURVE_ATTR) f32 curve segments; None without
    n_curve_segs: int = 0
    # features the port does not render yet; the routes that meet them raise
    n_instances: int = 0
    n_anim_tris: int = 0
    has_alpha: bool = False
    has_subsurface: bool = False
    has_hair: bool = False
    # a glass material with roughness (microfacet lobes); the BSDF skips
    # their math without one
    has_rough_glass: bool = False
    tex_slot_mask: int = 0
    mat_kind_mask: int = 1 << MATTE
    # participating media (K >= 1 rows; a scene without media holds one
    # unused row, as the JAX package's empty tables do): sigma_a, sigma_s
    # (K, 3), the HG asymmetry g (K,), the density grids (K, D, H, W),
    # padded with 0 to the largest (a homogeneous medium's grid is all
    # ones), world to the unit medium cube (K, 4, 4) and each grid's
    # largest density (K,), at least 1e-6
    med_sigma_a: torch.Tensor = None
    med_sigma_s: torch.Tensor = None
    med_g: torch.Tensor = None
    med_grid: torch.Tensor = None
    med_w2m: torch.Tensor = None
    med_max_density: torch.Tensor = None
    camera_medium: int = -1  # the medium the camera sits in, -1 vacuum
    has_grid: bool = False  # a grid wider than one voxel (the JAX volpath's _has_grid)
    # subsurface materials' folded BSSRDF tables (ops/bssrdf.py), B rows
    # indexed by the material's MP_BSSRDF: profile and cdf (B, 3, K),
    # rho_eff and sigma_t (B, 3), eta (B,); None without such a material
    bss_profile: torch.Tensor = None
    bss_cdf: torch.Tensor = None
    bss_rho_eff: torch.Tensor = None
    bss_sigma_t: torch.Tensor = None
    bss_eta: torch.Tensor = None
    # the infinite light (env_fields): its equirect radiance map (H, W, 3),
    # a (1, 1, 3) placeholder without one, light-to-world and its inverse
    # (4, 4), the map's importance (luminance x sin theta), and the light's
    # index (-1 without one)
    has_env: bool = False
    inf_radiance: torch.Tensor = None
    inf_l2w: torch.Tensor = None
    inf_w2l: torch.Tensor = None
    inf_dist: smp.Distribution2D = None
    env_light: int = -1
    # the Fourier material's table (ops/fourier_bsdf.make_fourier_table, one
    # a scene): the mu nodes (MU,), the dense coefficient rows (MU*MU,
    # 3*M_CAP), each cell's order (MU*MU,) int32, the cdf and a0 (MU, MU)
    # and eta (a 0-d tensor); None without a Fourier material's table
    has_fourier: bool = False
    fou_mu: torch.Tensor = None
    fou_dense: torch.Tensor = None
    fou_m: torch.Tensor = None
    fou_cdf: torch.Tensor = None
    fou_a0: torch.Tensor = None
    fou_eta: torch.Tensor = None

    @property
    def device(self) -> torch.device:
        return self.tri_attr.device


# the JAX package's Scene fields that scene_from_numpy reads; the flags
# there are encoded in the leading dimension of their shape
BRIDGE_FIELDS = (
    "tri_attr", "mat_attr", "light_attr", "light_power", "alight_tri_cdf", "world_center",
    "world_radius", "tri_p0", "light_type", "sph_o2w", "sph_attr", "quad_kind_flag",
    "sphlight_flag", "qdlight_flag", "crv_attr", "inst_o2w", "anim_p0", "inf_radiance",
    "inf_l2w", "inf_w2l",
    "alpha_flag", "bss_profile", "hair_flag", "tex_slot_flag", "mat_kind_flag",
    "bss_cdf", "bss_rho_eff", "bss_sigma_t", "bss_eta", "med_sigma_a", "med_sigma_s", "med_g",
    "med_grid", "med_w2m", "med_max_density", "camera_medium",
    "fou_mu", "fou_dense", "fou_m", "fou_cdf", "fou_a0", "fou_eta",
)


def type_mask(tags) -> int:
    """Bitmask with bit t set for every tag t in `tags`."""
    mask = 0
    for t in np.unique(np.asarray(tags, np.int64)):
        mask |= 1 << int(t)
    return mask


def rough_glass(mat_attr: np.ndarray) -> bool:
    """Whether any glass or subsurface row of mat_attr (M, N_MAT_ATTR), the
    materials with glass's surface lobes, has roughness."""
    rough = mat_attr[:, [MA_PARAMS + MP_ROUGH_U, MA_PARAMS + MP_ROUGH_V]].max(-1) > 0
    return bool(np.isin(np.rint(mat_attr[:, MA_TYPE]), (GLASS, SUBSURFACE))[rough].any())


def media_fields(med_sigma_a, med_sigma_s, med_g, med_grid, med_w2m, med_max_density,
                 camera_medium, device) -> dict:
    """Scene's media fields from numpy tables laid out as the JAX package's
    (K rows; a grid of (1, 1, 1) voxels is homogeneous)."""
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    grid = np.asarray(med_grid, np.float32)
    return dict(med_sigma_a=f32(med_sigma_a), med_sigma_s=f32(med_sigma_s), med_g=f32(med_g),
                med_grid=f32(grid), med_w2m=f32(med_w2m), med_max_density=f32(med_max_density),
                camera_medium=int(camera_medium), has_grid=grid.shape[1:] != (1, 1, 1))


def bssrdf_fields(profile, cdf, rho_eff, sigma_t, eta, device) -> dict:
    """Scene's BSSRDF fields (and has_subsurface) from numpy tables, B rows;
    None where B is 0."""
    if np.shape(profile)[0] == 0:
        return dict(has_subsurface=False)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return dict(has_subsurface=True, bss_profile=f32(profile), bss_cdf=f32(cdf),
                bss_rho_eff=f32(rho_eff), bss_sigma_t=f32(sigma_t), bss_eta=f32(eta))


def env_fields(radiance, l2w, w2l, light_type, device) -> dict:
    """Scene's infinite-light fields from the equirect map (H, W, 3) (a
    (1, 1, 3) placeholder: none) and its transforms, as the JAX
    finalize_scene makes them (scene/arrays.py:574-581): the importance is
    the map's luminance times sin theta of each row's centre, a uniform
    (1, 1) distribution without a map.  light_type: every light's LIGHT_*
    tag, for the infinite light's index."""
    rad = np.asarray(radiance, np.float32)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    has_env = rad.shape[0] > 1
    if has_env:
        h = rad.shape[0]
        lum = rad @ np.array([0.212671, 0.715160, 0.072169], np.float32)
        sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h).astype(np.float32)
        func = lum * sin_theta[:, None]
    else:
        func = np.ones((1, 1), np.float32)
    types = np.rint(np.asarray(light_type, np.float64)).astype(np.int64)
    inf = np.flatnonzero(types == LIGHT_INFINITE)
    return dict(has_env=has_env, inf_radiance=f32(rad), inf_l2w=f32(l2w), inf_w2l=f32(w2l),
                inf_dist=smp.make_distribution_2d(f32(func)),
                env_light=int(inf[0]) if inf.size else -1)


def fourier_fields(mu, dense, m, cdf, a0, eta, device) -> dict:
    """Scene's Fourier fields from the numpy table (ops/fourier_bsdf
    make_fourier_table's arrays); has_fourier False where mu has no node,
    as the JAX Scene's empty default (scene/arrays.py:494-499) holds."""
    if np.shape(mu)[0] == 0:
        return dict(has_fourier=False)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return dict(has_fourier=True, fou_mu=f32(mu), fou_dense=f32(dense),
                fou_m=torch.tensor(np.asarray(m, np.int32), device=device), fou_cdf=f32(cdf),
                fou_a0=f32(a0), fou_eta=f32(eta).reshape(()))


def scene_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> Scene:
    """Scene from numpy arrays named as the JAX package's Scene fields
    (``{k: np.asarray(getattr(jax_scene, k)) for k in BRIDGE_FIELDS}``).
    This is how scenes built by the JAX front ends (``load_pbrt``) reach the
    port until its own parser exists."""
    dev = resolve(device)
    crv = np.asarray(arrays["crv_attr"], np.float32).reshape(-1, N_CURVE_ATTR)

    def f32(k):
        return torch.tensor(np.asarray(arrays[k], np.float32), device=dev)

    def n(k):
        return int(np.shape(arrays[k])[0])

    return Scene(
        tri_attr=f32("tri_attr"),
        mat_attr=f32("mat_attr"),
        light_attr=f32("light_attr"),
        light_power=f32("light_power"),
        alight_tri_cdf=f32("alight_tri_cdf"),
        world_center=f32("world_center"),
        world_radius=float(arrays["world_radius"]),
        n_tris=n("tri_p0"),
        n_lights=n("light_type"),
        sph_attr=f32("sph_attr"),
        n_spheres=n("sph_o2w"),
        quad_kind_mask=n("quad_kind_flag"),
        light_type_mask=type_mask(arrays["light_type"]),
        has_sphere_lights=n("sphlight_flag") > 0,
        has_quadric_lights=n("qdlight_flag") > 0,
        crv_attr=torch.tensor(crv, device=dev) if crv.shape[0] else None,
        n_curve_segs=crv.shape[0],
        n_instances=n("inst_o2w"),
        n_anim_tris=n("anim_p0"),
        has_alpha=n("alpha_flag") > 0,
        has_hair=n("hair_flag") > 0,
        has_rough_glass=rough_glass(np.asarray(arrays["mat_attr"], np.float32)),
        tex_slot_mask=n("tex_slot_flag"),
        mat_kind_mask=n("mat_kind_flag"),
        **media_fields(*(arrays[k] for k in (
            "med_sigma_a", "med_sigma_s", "med_g", "med_grid", "med_w2m", "med_max_density",
            "camera_medium")), dev),
        **bssrdf_fields(*(arrays[k] for k in (
            "bss_profile", "bss_cdf", "bss_rho_eff", "bss_sigma_t", "bss_eta")), dev),
        **env_fields(arrays["inf_radiance"], arrays["inf_l2w"], arrays["inf_w2l"],
                     arrays["light_type"], dev),
        **fourier_fields(*(arrays[k] for k in (
            "fou_mu", "fou_dense", "fou_m", "fou_cdf", "fou_a0", "fou_eta")), dev),
    )
