"""Flat scene tables: the column layout and the Scene of torch tensors.

The layout (column constants) is the JAX package's ``scene/arrays.py``,
kept here as the port's own copy.  The Scene holds only what the ported
paths read: the packed triangle, quadric, material and light tables, the
light-pick power and the per-light triangle-area CDF, the media (a
homogeneous table and the density grids) and the subsurface materials'
folded BSSRDF profiles, the infinite light's map, transforms and
importance, the Fourier BSDF's table, the texture tables and image atlas
(``ops/texture.py``), the instanced prototypes and their instances, the
animated meshes, plus the counts and feature flags that decide which
route a scene may take (``ops/path_kernel.mega_cfg``) and which parts the
port refuses.  A primitive's media are its inside and outside
medium ids, columns TA_MED_IN/OUT of tri_attr and SP_MED_IN/OUT of
sph_attr (-1: vacuum).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..device import resolve
from ..ops import mipmap as mm
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

# texturable slots (mat_attr's MA_TEX columns hold a texture id or -1)
TEX_SLOT_KD = 0
TEX_SLOT_KS = 1
TEX_SLOT_KR = 2
TEX_SLOT_KT = 3
TEX_SLOT_SIGMA = 4
TEX_SLOT_ROUGH_U = 5
TEX_SLOT_ROUGH_V = 6
TEX_SLOT_BUMP = 7
TEX_SLOT_OPACITY = 8
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
    # a triangle with an alpha or shadow-alpha mask (TA_ALPHA, TA_SALPHA)
    has_alpha: bool = False
    # two-level instancing (reference primitive.rs:198-265): the prototypes'
    # object-space triangle rows (max(PT, 1), N_TRI_ATTR), each prototype's
    # rows [start, end) (P, 2) int32, and per instance its object-to-world
    # and world-to-object matrices (I, 4, 4), prototype (I,) int32 and
    # material override (I,) int32 (-1: the prototype's own)
    n_instances: int = 0
    n_proto_tris: int = 0
    proto_attr: torch.Tensor = None
    proto_range: torch.Tensor = None
    inst_o2w: torch.Tensor = None
    inst_w2o: torch.Tensor = None
    inst_proto: torch.Tensor = None
    inst_mat: torch.Tensor = None
    # animated triangle meshes (object motion): their object-space rows
    # (max(A, 1), N_TRI_ATTR), each group's rows [start, end) (G, 2) int32
    # and its transform at the shutter's ends (G, 32): T0, q0, S0, T1, q1,
    # S1 (utils/animated.xf_parts)
    n_anim_tris: int = 0
    anim_attr: torch.Tensor = None
    anim_range: torch.Tensor = None
    anim_xf: torch.Tensor = None
    has_subsurface: bool = False
    has_hair: bool = False
    # a glass material with roughness (microfacet lobes); the BSDF skips
    # their math without one
    has_rough_glass: bool = False
    tex_slot_mask: int = 0  # bit s set when a material binds a texture to slot s
    mat_kind_mask: int = 1 << MATTE
    # textures (texture_fields): the type tags (X,) int32, parameters (X,
    # 16), children (X, 2) int32, world-to-texture transforms (X, 4, 4),
    # the atlas of every image's pyramid (AH, AW, 3), level 0's rect (y0,
    # h, w, wrap) (X, 4) int32, every level's (y0, h, w) (X, 12, 3) int32
    # and the levels (X,) int32; one unused row and a (1, 1, 3) atlas
    # without textures.  tex_kind_mask: bit t set for each type tag present
    # (0 where the table has one row and no slot is bound)
    tex_type: torch.Tensor = None
    tex_params: torch.Tensor = None
    tex_child: torch.Tensor = None
    tex_w2t: torch.Tensor = None
    tex_atlas: torch.Tensor = None
    tex_rect: torch.Tensor = None
    tex_mip: torch.Tensor = None
    tex_nlv: torch.Tensor = None
    tex_kind_mask: int = 0
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
    # a triangle or quadric with an inside or outside medium, or a camera in
    # one (the JAX Scene's has_media, its med_flag): BDPT's walks then
    # sample media and draw 5 dims a vertex
    has_media: bool = False
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
    "sphlight_flag", "qdlight_flag", "crv_attr", "inf_radiance",
    "inf_l2w", "inf_w2l",
    "alpha_flag", "bss_profile", "hair_flag", "tex_slot_flag", "mat_kind_flag",
    "bss_cdf", "bss_rho_eff", "bss_sigma_t", "bss_eta", "med_sigma_a", "med_sigma_s", "med_g",
    "med_grid", "med_w2m", "med_max_density", "camera_medium",
    "fou_mu", "fou_dense", "fou_m", "fou_cdf", "fou_a0", "fou_eta",
    "tex_type", "tex_params", "tex_child", "tex_w2t", "tex_atlas", "tex_rect", "tex_mip",
    "tex_nlv", "tex_kind_flag",
    "proto_p0", "proto_p1", "proto_p2", "proto_attr", "proto_range",
    "inst_o2w", "inst_w2o", "inst_proto", "inst_mat",
    "anim_p0", "anim_p1", "anim_p2", "anim_attr", "anim_range", "anim_xf",
)
TEXTURE_TABLES = ("tex_type", "tex_params", "tex_child", "tex_w2t", "tex_atlas", "tex_rect",
                  "tex_mip", "tex_nlv")


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


def media_present(tri_attr, n_tris: int, sph_attr, n_spheres: int, camera_medium) -> bool:
    """The JAX finalize_scene's media flag (scene/arrays.py:664-671): a
    triangle or quadric row with an inside or outside medium, or the camera
    in one.  tri_attr, sph_attr: numpy rows."""
    tri = np.asarray(tri_attr, np.float32)[:n_tris][:, [TA_MED_IN, TA_MED_OUT]]
    sph = np.asarray(sph_attr, np.float32)[:n_spheres][:, [SP_MED_IN, SP_MED_OUT]]
    return bool((np.rint(tri) >= 0).any() or (np.rint(sph) >= 0).any()
                or int(camera_medium) >= 0)


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


def empty_texture_tables() -> dict:
    """The texture tables of a scene without textures (the JAX package's
    empty defaults, scene/arrays.py:455-463): one unused row."""
    return dict(tex_type=np.zeros(1, np.int32), tex_params=np.zeros((1, 16), np.float32),
                tex_child=np.full((1, 2), -1, np.int32),
                tex_w2t=np.eye(4, dtype=np.float32)[None],
                tex_atlas=np.zeros((1, 1, 3), np.float32), tex_rect=np.zeros((1, 4), np.int32),
                tex_mip=np.zeros((1, mm.MAX_LEVELS, 3), np.int32),
                tex_nlv=np.ones(1, np.int32))


def texture_kind_mask(tex_type, mat_attr) -> int:
    """Bit t set for each texture type tag present, 0 where the table has
    one row and no material binds a slot (the JAX finalize_scene's rule,
    scene/arrays.py:670-676)."""
    tex_type = np.asarray(tex_type)
    bound = (np.rint(np.asarray(mat_attr)[:, MA_TEX:MA_TEX + N_TEX_SLOTS]) >= 0).any()
    return 0 if tex_type.shape[0] <= 1 and not bound else type_mask(tex_type)


def slot_mask(mat_attr) -> int:
    """Bit s set for each texture slot s some material binds."""
    bound = (np.rint(np.asarray(mat_attr)[:, MA_TEX:MA_TEX + N_TEX_SLOTS]) >= 0).any(0)
    return sum(1 << s for s in np.flatnonzero(bound))


def motion_fields(proto_attr, proto_range, inst_o2w, inst_w2o, inst_proto, inst_mat,
                  anim_attr, anim_range, anim_xf, n_proto_tris: int, n_anim_tris: int,
                  device) -> dict:
    """Scene's instancing and animated-mesh fields from numpy tables laid
    out as the JAX package's (scene/arrays.py:448-460): prototype and
    animated rows with at least one row, the others with one row an
    instance or group."""
    f32 = lambda a, cols: torch.tensor(np.asarray(a, np.float32).reshape(-1, cols), device=device)
    i32 = lambda a, cols: torch.tensor(np.asarray(a, np.int32).reshape(-1, cols), device=device)
    return dict(
        n_instances=int(np.shape(inst_proto)[0]), n_proto_tris=int(n_proto_tris),
        proto_attr=f32(proto_attr, N_TRI_ATTR), proto_range=i32(proto_range, 2),
        inst_o2w=f32(inst_o2w, 16).reshape(-1, 4, 4), inst_w2o=f32(inst_w2o, 16).reshape(-1, 4, 4),
        inst_proto=i32(inst_proto, 1)[:, 0], inst_mat=i32(inst_mat, 1)[:, 0],
        n_anim_tris=int(n_anim_tris), anim_attr=f32(anim_attr, N_TRI_ATTR),
        anim_range=i32(anim_range, 2), anim_xf=f32(anim_xf, 32))


def empty_motion_tables() -> dict:
    """motion_fields' tables of a scene without instances or animated
    meshes (the JAX package's empty defaults)."""
    return dict(proto_attr=np.zeros((1, N_TRI_ATTR), np.float32),
                proto_range=np.zeros((0, 2), np.int32), inst_o2w=np.zeros((0, 4, 4), np.float32),
                inst_w2o=np.zeros((0, 4, 4), np.float32), inst_proto=np.zeros(0, np.int32),
                inst_mat=np.zeros(0, np.int32), anim_attr=np.zeros((1, N_TRI_ATTR), np.float32),
                anim_range=np.zeros((0, 2), np.int32), anim_xf=np.zeros((0, 32), np.float32),
                n_proto_tris=0, n_anim_tris=0)


def texture_fields(tables: Mapping[str, np.ndarray], kind_mask: int, device) -> dict:
    """Scene's texture fields from the numpy tables named as TEXTURE_TABLES
    (laid out as the JAX package's) and the kind mask."""
    f32 = lambda k: torch.tensor(np.asarray(tables[k], np.float32), device=device)
    i32 = lambda k: torch.tensor(np.asarray(tables[k], np.int32), device=device)
    return dict(tex_type=i32("tex_type"), tex_params=f32("tex_params"),
                tex_child=i32("tex_child"), tex_w2t=f32("tex_w2t"), tex_atlas=f32("tex_atlas"),
                tex_rect=i32("tex_rect"), tex_mip=i32("tex_mip"), tex_nlv=i32("tex_nlv"),
                tex_kind_mask=int(kind_mask))


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
        **motion_fields(*(arrays[k] for k in (
            "proto_attr", "proto_range", "inst_o2w", "inst_w2o", "inst_proto", "inst_mat",
            "anim_attr", "anim_range", "anim_xf")), n("proto_p0"), n("anim_p0"), dev),
        has_alpha=n("alpha_flag") > 0,
        has_hair=n("hair_flag") > 0,
        has_rough_glass=rough_glass(np.asarray(arrays["mat_attr"], np.float32)),
        tex_slot_mask=n("tex_slot_flag"),
        mat_kind_mask=n("mat_kind_flag"),
        **media_fields(*(arrays[k] for k in (
            "med_sigma_a", "med_sigma_s", "med_g", "med_grid", "med_w2m", "med_max_density",
            "camera_medium")), dev),
        has_media=media_present(arrays["tri_attr"], n("tri_p0"), arrays["sph_attr"],
                                n("sph_o2w"), arrays["camera_medium"]),
        **bssrdf_fields(*(arrays[k] for k in (
            "bss_profile", "bss_cdf", "bss_rho_eff", "bss_sigma_t", "bss_eta")), dev),
        **env_fields(arrays["inf_radiance"], arrays["inf_l2w"], arrays["inf_w2l"],
                     arrays["light_type"], dev),
        **fourier_fields(*(arrays[k] for k in (
            "fou_mu", "fou_dense", "fou_m", "fou_cdf", "fou_a0", "fou_eta")), dev),
        **texture_fields(arrays, n("tex_kind_flag"), dev),
    )
