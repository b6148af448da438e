"""Flat scene tables: the column layout and the Scene of torch tensors.

The layout (column constants) is the JAX package's ``scene/arrays.py``,
kept here as the port's own copy.  The Scene holds only what the ported
paths read: the packed triangle, quadric, material and light tables, the
light-pick power and the per-light triangle-area CDF, plus the counts and
feature flags that decide which route a scene may take
(``ops/path_kernel.mega_cfg``) and which parts the port refuses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..device import resolve

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
    # features the port does not render yet; the routes that meet them raise
    n_curve_segs: int = 0
    n_instances: int = 0
    n_anim_tris: int = 0
    has_env: bool = False
    has_alpha: bool = False
    has_subsurface: bool = False
    has_hair: bool = False
    tex_slot_mask: int = 0
    mat_kind_mask: int = 1 << MATTE

    @property
    def device(self) -> torch.device:
        return self.tri_attr.device


# the JAX package's Scene fields that scene_from_numpy reads; the flags
# there are encoded in the leading dimension of their shape
BRIDGE_FIELDS = (
    "tri_attr", "mat_attr", "light_attr", "light_power", "alight_tri_cdf", "world_center",
    "world_radius", "tri_p0", "light_type", "sph_o2w", "sph_attr", "quad_kind_flag",
    "sphlight_flag", "qdlight_flag", "crv_attr", "inst_o2w", "anim_p0", "inf_radiance",
    "alpha_flag", "bss_profile", "hair_flag", "tex_slot_flag", "mat_kind_flag",
)


def type_mask(tags) -> int:
    """Bitmask with bit t set for every tag t in `tags`."""
    mask = 0
    for t in np.unique(np.asarray(tags, np.int64)):
        mask |= 1 << int(t)
    return mask


def scene_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> Scene:
    """Scene from numpy arrays named as the JAX package's Scene fields
    (``{k: np.asarray(getattr(jax_scene, k)) for k in BRIDGE_FIELDS}``).
    This is how scenes built by the JAX front ends (``load_pbrt``) reach the
    port until its own parser exists."""
    dev = resolve(device)

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
        n_curve_segs=n("crv_attr"),
        n_instances=n("inst_o2w"),
        n_anim_tris=n("anim_p0"),
        has_env=n("inf_radiance") > 1,
        has_alpha=n("alpha_flag") > 0,
        has_subsurface=n("bss_profile") > 0,
        has_hair=n("hair_flag") > 0,
        tex_slot_mask=n("tex_slot_flag"),
        mat_kind_mask=n("mat_kind_flag"),
    )
