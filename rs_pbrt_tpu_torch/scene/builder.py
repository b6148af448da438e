"""Programmatic scene construction -> Scene of torch tensors.

The port's reduced copy of the JAX package's ``scene/builder.py`` (reference
api.rs make_* factories): matte materials and triangle meshes, optionally
emissive (triangle-range diffuse area lights), finalized into the packed
tables of ``scene/arrays.py``.  ``finalize`` also does what the JAX
``arrays.finalize_scene`` does for such scenes: the world bound, the light
parameters that depend on it, the per-light triangle-area CDF and the
light-selection power.  Other shapes, materials and lights are not ported
yet (ROADMAP slice 7); scenes that need them come from the JAX front ends
through ``arrays.scene_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..models.lights import compute_light_power
from . import arrays as sa


class SceneBuilder:
    def __init__(self):
        self.tri_blocks = []  # (T_i, N_TRI_ATTR) f32 rows per mesh
        self.n_tri_rows = 0
        self.mats = []  # (type, params (N_MAT_PARAMS,), tex (N_TEX_SLOTS,))
        self.lights = []  # dicts: params, tri_start, tri_end, tri_areas
        self.add_matte(kd=(0.5, 0.5, 0.5))  # default material 0 (api.rs)

    def add_matte(self, kd=(0.5, 0.5, 0.5), sigma=0.0) -> int:
        """Matte material (materials/matte.rs) with the JAX builder's
        defaults in the unused parameter slots; returns its id."""
        p = np.zeros(sa.N_MAT_PARAMS, np.float32)
        p[sa.MP_KD:sa.MP_KD + 3] = kd
        p[sa.MP_ETA] = 1.5
        p[sa.MP_SIGMA] = sigma
        p[sa.MP_REMAP_ROUGH] = 1.0
        p[sa.MP_ETA3:sa.MP_ETA3 + 3] = (0.2, 0.92, 1.1)
        p[sa.MP_K3:sa.MP_K3 + 3] = (3.9, 2.45, 2.14)
        p[sa.MP_OPACITY:sa.MP_OPACITY + 3] = (1, 1, 1)
        p[sa.MP_BSSRDF] = -1
        self.mats.append((sa.MATTE, p, np.full(sa.N_TEX_SLOTS, -1, np.int32)))
        return len(self.mats) - 1

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
            light_id = self._add_area_light(P, idx, **area_light)
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

    def _add_area_light(self, P, idx, L=(1, 1, 1), two_sided=False, scale=(1, 1, 1)) -> int:
        areas = np.zeros(len(idx), np.float32)
        for k, (i0, i1, i2) in enumerate(idx):
            areas[k] = 0.5 * np.linalg.norm(np.cross(P[i1] - P[i0], P[i2] - P[i0]))
        lp = np.zeros(sa.N_LIGHT_PARAMS, np.float32)
        lp[sa.LP_I:sa.LP_I + 3] = np.asarray(L, np.float32) * np.asarray(scale, np.float32)
        lp[sa.LP_TWO_SIDED] = float(two_sided)
        lp[sa.LP_AREA] = float(areas.sum())
        self.lights.append(dict(params=lp, tri_start=self.n_tri_rows,
                                tri_end=self.n_tri_rows + len(idx), tri_areas=areas))
        return len(self.lights) - 1

    def finalize(self, device="cuda") -> sa.Scene:
        dev = resolve(device)
        n_tri, n_l = self.n_tri_rows, len(self.lights)
        tri_attr = (np.concatenate(self.tri_blocks) if n_tri
                    else np.zeros((1, sa.N_TRI_ATTR), np.float32))

        # world bound over every vertex (arrays.finalize_scene)
        if n_tri:
            allp = np.concatenate([tri_attr[:, c:c + 3] for c in (sa.TA_P0, sa.TA_P1, sa.TA_P2)])
            lo, hi = allp.min(0), allp.max(0)
            center = 0.5 * (lo + hi)
            radius = float(np.linalg.norm(hi - center)) + 1e-6
        else:
            center, radius = np.zeros(3, np.float32), 1.0

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
            light_attr[li, sa.LA_GEOM] = sa.ALG_TRI_RANGE
            light_attr[li, sa.LA_TRI_START] = l["tri_start"]
            light_attr[li, sa.LA_TRI_END] = l["tri_end"]
            a = np.asarray(l["tri_areas"], np.float64)
            c = np.concatenate([[0.0], np.cumsum(a)]) / max(a.sum(), 1e-12)
            cdf[li, :len(c)] = c
            cdf[li, len(c):] = 1.0
        power = (compute_light_power(np.full(n_l, sa.LIGHT_AREA), light_attr[:n_l, :sa.N_LIGHT_PARAMS])
                 if n_l else np.ones(0, np.float32))

        mat_kind_mask = 0
        for mtype, _, _ in self.mats:
            mat_kind_mask |= 1 << int(mtype)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return sa.Scene(
            tri_attr=f32(tri_attr), mat_attr=f32(mat_attr), light_attr=f32(light_attr),
            light_power=f32(power), alight_tri_cdf=f32(cdf), world_center=f32(center),
            world_radius=float(np.float32(radius)), n_tris=n_tri, n_lights=n_l,
            mat_kind_mask=mat_kind_mask,
        )
