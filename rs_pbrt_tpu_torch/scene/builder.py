"""Programmatic scene construction -> Scene of torch tensors.

The port's reduced copy of the JAX package's ``scene/builder.py`` (reference
api.rs make_* factories): matte and mirror materials, triangle meshes and
spheres, either of them optionally emissive (diffuse area lights on a
triangle range or on a sphere), finalized into the packed tables of
``scene/arrays.py``.  ``finalize`` also does what the JAX
``arrays.finalize_scene`` does for such scenes: the world bound, the light
parameters that depend on it, the per-light triangle-area CDF and the
light-selection power.  Other shapes, materials and lights are not ported
yet (ROADMAP); scenes that need them come from the JAX front ends through
``arrays.scene_from_numpy``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve
from ..models.lights import compute_light_power
from ..utils import transform as tr
from . import arrays as sa


class SceneBuilder:
    def __init__(self):
        self.tri_blocks = []  # (T_i, N_TRI_ATTR) f32 rows per mesh
        self.n_tri_rows = 0
        self.sph_rows = []  # (N_SPH_ATTR,) f32 row per quadric
        self.mats = []  # (type, params (N_MAT_PARAMS,), tex (N_TEX_SLOTS,))
        self.lights = []  # dicts: params, geom, tri_start, tri_end, shape_idx, tri_areas
        self.add_matte(kd=(0.5, 0.5, 0.5))  # default material 0 (api.rs)

    def _add_material(self, mtype, kd=(0, 0, 0), kr=(0, 0, 0), sigma=0.0) -> int:
        """A material row with the JAX builder's defaults in the parameter
        slots the material does not set; returns its id."""
        p = np.zeros(sa.N_MAT_PARAMS, np.float32)
        p[sa.MP_KD:sa.MP_KD + 3] = kd
        p[sa.MP_KR:sa.MP_KR + 3] = kr
        p[sa.MP_ETA] = 1.5
        p[sa.MP_SIGMA] = sigma
        p[sa.MP_REMAP_ROUGH] = 1.0
        p[sa.MP_ETA3:sa.MP_ETA3 + 3] = (0.2, 0.92, 1.1)
        p[sa.MP_K3:sa.MP_K3 + 3] = (3.9, 2.45, 2.14)
        p[sa.MP_OPACITY:sa.MP_OPACITY + 3] = (1, 1, 1)
        p[sa.MP_BSSRDF] = -1
        self.mats.append((mtype, p, np.full(sa.N_TEX_SLOTS, -1, np.int32)))
        return len(self.mats) - 1

    def add_matte(self, kd=(0.5, 0.5, 0.5), sigma=0.0) -> int:
        """Matte material (materials/matte.rs): Lambert, Oren-Nayar for
        sigma > 0 (degrees)."""
        return self._add_material(sa.MATTE, kd=kd, sigma=sigma)

    def add_mirror(self, kr=(0.9, 0.9, 0.9)) -> int:
        """Perfect mirror (materials/mirror.rs)."""
        return self._add_material(sa.MIRROR, kr=kr)

    def add_triangle_mesh(self, indices, positions, normals=None, uvs=None, material: int = 0,
                          area_light=None, reverse_orientation: bool = False) -> int:
        """World-space triangle mesh.  area_light: dict(L=(r,g,b),
        two_sided=bool, scale=(r,g,b)) makes every triangle emissive.
        Returns the light id, or -1."""
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        P = np.asarray(positions, np.float32).reshape(-1, 3)
        n_tri = len(idx)
        i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
        light_id = -1
        if area_light is not None:
            light_id = self._add_area_light_tri(P, idx, **area_light)
        rows = np.zeros((n_tri, sa.N_TRI_ATTR), np.float32)
        rows[:, sa.TA_P0:sa.TA_P0 + 3] = P[i0]
        rows[:, sa.TA_P1:sa.TA_P1 + 3] = P[i1]
        rows[:, sa.TA_P2:sa.TA_P2 + 3] = P[i2]
        if normals is not None:
            N = np.asarray(normals, np.float32).reshape(-1, 3)
            rows[:, sa.TA_N0:sa.TA_N0 + 3] = N[i0]
            rows[:, sa.TA_N1:sa.TA_N1 + 3] = N[i1]
            rows[:, sa.TA_N2:sa.TA_N2 + 3] = N[i2]
            rows[:, sa.TA_HAS_N] = 1.0
        if uvs is not None:
            U = np.asarray(uvs, np.float32).reshape(-1, 2)
            rows[:, sa.TA_UV0:sa.TA_UV0 + 2] = U[i0]
            rows[:, sa.TA_UV1:sa.TA_UV1 + 2] = U[i1]
            rows[:, sa.TA_UV2:sa.TA_UV2 + 2] = U[i2]
        else:  # the default parameterization (triangle.rs)
            rows[:, sa.TA_UV1:sa.TA_UV1 + 2] = (1, 0)
            rows[:, sa.TA_UV2:sa.TA_UV2 + 2] = (1, 1)
        rows[:, sa.TA_MAT] = material
        rows[:, sa.TA_LIGHT] = light_id
        rows[:, sa.TA_REVERSE] = float(reverse_orientation)
        rows[:, [sa.TA_MED_IN, sa.TA_MED_OUT, sa.TA_ALPHA, sa.TA_SALPHA]] = -1.0
        self.tri_blocks.append(rows)
        self.n_tri_rows += n_tri
        return light_id

    def add_sphere(self, object_to_world: Optional[tr.Transform] = None, radius=1.0, z_min=None,
                   z_max=None, phi_max=360.0, material: int = 0, area_light=None,
                   reverse_orientation: bool = False) -> int:
        """Analytic (partial) sphere (shapes/sphere.rs) in object space under
        object_to_world.  area_light: dict(L=(r,g,b), two_sided=bool,
        scale=(r,g,b)) makes it a diffuse area light.  Returns the light id,
        or -1."""
        o2w = object_to_world or tr.identity()
        z_min = -radius if z_min is None else z_min
        z_max = radius if z_max is None else z_max
        light_id = -1
        if area_light is not None:
            # full-sphere area in world units, the o2w uniform scale folded in
            scale = float(np.linalg.norm(np.asarray(o2w.m, np.float32)[:3, 0]))
            lp = np.zeros(sa.N_LIGHT_PARAMS, np.float32)
            lp[sa.LP_I:sa.LP_I + 3] = (np.asarray(area_light.get("L", (1, 1, 1)), np.float32)
                                       * np.asarray(area_light.get("scale", (1, 1, 1)), np.float32))
            lp[sa.LP_TWO_SIDED] = float(area_light.get("two_sided", False))
            lp[sa.LP_AREA] = 4.0 * np.pi * (radius * scale) ** 2
            self.lights.append(dict(params=lp, geom=sa.ALG_SPHERE, tri_start=0, tri_end=0,
                                    shape_idx=len(self.sph_rows), tri_areas=None))
            light_id = len(self.lights) - 1
        row = np.zeros(sa.N_SPH_ATTR, np.float32)
        row[sa.SP_O2W:sa.SP_O2W + 16] = np.asarray(o2w.m, np.float32).reshape(16)
        row[sa.SP_W2O:sa.SP_W2O + 16] = np.asarray(o2w.m_inv, np.float32).reshape(16)
        row[sa.SP_PARAMS:sa.SP_PARAMS + 4] = (radius, z_min, z_max, np.deg2rad(phi_max))
        row[sa.SP_MAT] = material
        row[sa.SP_LIGHT] = light_id
        row[sa.SP_REVERSE] = float(reverse_orientation)
        row[[sa.SP_MED_IN, sa.SP_MED_OUT]] = -1.0
        row[sa.SP_KIND] = sa.QK_SPHERE
        self.sph_rows.append(row)
        return light_id

    def _add_area_light_tri(self, P, idx, L=(1, 1, 1), two_sided=False, scale=(1, 1, 1)) -> int:
        areas = np.zeros(len(idx), np.float32)
        for k, (i0, i1, i2) in enumerate(idx):
            areas[k] = 0.5 * np.linalg.norm(np.cross(P[i1] - P[i0], P[i2] - P[i0]))
        lp = np.zeros(sa.N_LIGHT_PARAMS, np.float32)
        lp[sa.LP_I:sa.LP_I + 3] = np.asarray(L, np.float32) * np.asarray(scale, np.float32)
        lp[sa.LP_TWO_SIDED] = float(two_sided)
        lp[sa.LP_AREA] = float(areas.sum())
        self.lights.append(dict(params=lp, geom=sa.ALG_TRI_RANGE, tri_start=self.n_tri_rows,
                                tri_end=self.n_tri_rows + len(idx), shape_idx=0,
                                tri_areas=areas))
        return len(self.lights) - 1

    def _world_bound(self, tri_attr, sph_attr):
        """Center and radius of the bound over every vertex and every
        quadric's transformed center +- its scaled bounding radius
        (arrays.finalize_scene)."""
        pts = []
        if self.n_tri_rows:
            pts += [tri_attr[:, c:c + 3] for c in (sa.TA_P0, sa.TA_P1, sa.TA_P2)]
        if self.sph_rows:
            o2w = sph_attr[:, sa.SP_O2W:sa.SP_O2W + 16].reshape(-1, 4, 4)
            c = o2w[:, :3, 3]
            scale = np.linalg.norm(o2w[:, :3, :3], axis=(1, 2))
            prm = sph_attr[:, sa.SP_PARAMS:sa.SP_PARAMS + 4]
            zmag = np.maximum(np.abs(prm[:, 1]), np.abs(prm[:, 2]))
            kind = np.rint(sph_attr[:, sa.SP_KIND])
            rb = np.where(kind == sa.QK_SPHERE, prm[:, 0],
                          np.sqrt(prm[:, 0] ** 2 + zmag ** 2)).astype(np.float32)
            r = rb * scale
            pts += [c - r[:, None], c + r[:, None]]
        if not pts:
            return np.zeros(3, np.float32), 1.0
        allp = np.concatenate(pts, 0)
        lo, hi = allp.min(0), allp.max(0)
        center = 0.5 * (lo + hi)
        return center, float(np.linalg.norm(hi - center)) + 1e-6

    def finalize(self, device="cuda") -> sa.Scene:
        dev = resolve(device)
        n_tri, n_l, n_sph = self.n_tri_rows, len(self.lights), len(self.sph_rows)
        tri_attr = (np.concatenate(self.tri_blocks) if n_tri
                    else np.zeros((1, sa.N_TRI_ATTR), np.float32))
        sph_attr = (np.stack(self.sph_rows) if n_sph
                    else np.zeros((1, sa.N_SPH_ATTR), np.float32))
        center, radius = self._world_bound(tri_attr, sph_attr)

        mat_attr = np.zeros((len(self.mats), sa.N_MAT_ATTR), np.float32)
        for i, (mtype, p, tex) in enumerate(self.mats):
            mat_attr[i, sa.MA_TYPE] = mtype
            mat_attr[i, sa.MA_PARAMS:sa.MA_PARAMS + sa.N_MAT_PARAMS] = p
            mat_attr[i, sa.MA_TEX:sa.MA_TEX + sa.N_TEX_SLOTS] = tex

        max_range = max([l["tri_end"] - l["tri_start"] for l in self.lights] + [1])
        light_attr = np.zeros((max(n_l, 1), sa.N_LIGHT_ATTR), np.float32)
        cdf = np.zeros((n_l, max_range + 1), np.float32)
        for li, l in enumerate(self.lights):
            lp = l["params"].copy()
            lp[sa.LP_WORLD_RADIUS] = radius
            lp[sa.LP_WORLD_CENTER:sa.LP_WORLD_CENTER + 3] = center
            light_attr[li, :sa.N_LIGHT_PARAMS] = lp
            light_attr[li, sa.LA_TYPE] = sa.LIGHT_AREA
            light_attr[li, sa.LA_FLAGS] = sa.LF_AREA
            light_attr[li, sa.LA_GEOM] = l["geom"]
            light_attr[li, sa.LA_TRI_START] = l["tri_start"]
            light_attr[li, sa.LA_TRI_END] = l["tri_end"]
            light_attr[li, sa.LA_SHAPE_IDX] = l["shape_idx"]
            if l["tri_areas"] is not None:
                a = np.asarray(l["tri_areas"], np.float64)
                c = np.concatenate([[0.0], np.cumsum(a)]) / max(a.sum(), 1e-12)
                cdf[li, :len(c)] = c
                cdf[li, len(c):] = 1.0
            else:  # not a triangle range: the uniform CDF, never read
                cdf[li] = np.linspace(0, 1, max_range + 1)
        power = (compute_light_power(np.full(n_l, sa.LIGHT_AREA), light_attr[:n_l, :sa.N_LIGHT_PARAMS])
                 if n_l else np.ones(0, np.float32))
        geoms = [l["geom"] for l in self.lights]

        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return sa.Scene(
            tri_attr=f32(tri_attr), mat_attr=f32(mat_attr), light_attr=f32(light_attr),
            light_power=f32(power), alight_tri_cdf=f32(cdf), world_center=f32(center),
            world_radius=float(np.float32(radius)), n_tris=n_tri, n_lights=n_l,
            sph_attr=f32(sph_attr), n_spheres=n_sph,
            quad_kind_mask=sa.type_mask([r[sa.SP_KIND] for r in self.sph_rows]),
            light_type_mask=sa.type_mask([sa.LIGHT_AREA] * n_l),
            has_sphere_lights=sa.ALG_SPHERE in geoms,
            mat_kind_mask=sa.type_mask([m[0] for m in self.mats]),
        )
