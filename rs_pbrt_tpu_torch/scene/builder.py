"""Programmatic scene construction -> Scene of torch tensors.

The port's reduced copy of the JAX package's ``scene/builder.py`` (reference
api.rs make_* factories): the matte, plastic, mirror, glass, metal,
substrate, uber, translucent, Disney, hair, subsurface, Fourier and mix
materials (the JAX builder's signatures and parameter packing), textures
bound to their slots (``add_texture``, ``set_material_texture``),
triangle meshes (with alpha and shadow-alpha masks), spheres, cylinders
and disks, each of them optionally emissive (diffuse area lights on a
triangle range or on a quadric) and with a medium interface, cubic Bézier
curves (flattened to segments at once, ``ops/curves.py``), point, spot,
distant, projection, goniometric and infinite lights, and homogeneous and
density-grid media, finalized into the packed tables of
``scene/arrays.py``.  ``finalize`` also does what the JAX
``arrays.finalize_scene`` does for such scenes: the world bound, the light
parameters that depend on it, the per-light triangle-area CDF and the
light-selection power (the infinite light's from its map's mean, as the
JAX builder's finalize takes it); it stacks the media's grids and the
subsurface materials' folded BSSRDF tables, carries the Fourier
material's table, makes the environment map's importance and packs every
image's MIP pyramid into the texture atlas as the JAX ``finalize`` does.
Instanced prototypes (``add_prototype_mesh``, ``add_prototype_tris``,
``add_instance``) keep one object-space copy of each mesh, and animated
meshes (``add_animated_triangle_mesh``) keep their object-space rows and
their transform's two ends decomposed; the world bound takes in each
instance's transformed box and each animated mesh's motion bound, as the
JAX ``finalize_scene`` does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve
from ..models.lights import compute_light_power
from ..ops import bssrdf as bss
from ..ops import curves as cv
from ..ops import fourier_bsdf as fb
from ..ops import mipmap as mm
from ..ops import texture as tx
from ..utils import animated as an
from ..utils import spectrum
from ..utils import transform as tr
from . import arrays as sa


class SceneBuilder:
    def __init__(self):
        self.tri_blocks = []  # (T_i, N_TRI_ATTR) f32 rows per mesh
        self.n_tri_rows = 0
        self.sph_rows = []  # (N_SPH_ATTR,) f32 row per quadric
        self.mats = []  # (type, params (N_MAT_PARAMS,), tex (N_TEX_SLOTS,))
        # dicts: type, params, geom, tri_start, tri_end, shape_idx, tri_areas (spot_dir)
        self.lights = []
        self.curves = []  # (C_i, N_CURVE_ATTR) f32 segment rows per add_curve
        self.bssrdfs = []  # per subsurface material, ops/bssrdf.make_material_tables' dict
        self.media = []  # (sigma_a, sigma_s, g, grid or None, w2m) per medium
        self.camera_medium = -1  # the medium the camera sits in; -1 vacuum
        self.env = None  # the infinite light's (map, light-to-world, inverse)
        self.fourier_table = None  # the Fourier material's dense table (one a scene)
        self.textures = []  # (type, params (16,), children (2,), w2t (4, 4), image or None)
        self.protos = []  # (T_i, N_TRI_ATTR) f32 object-space rows per prototype
        self.instances = []  # (prototype id, object-to-world (4, 4) f32, material or -1)
        self.anims = []  # ((T_i, N_TRI_ATTR) f32 object-space rows, xf (32,) f32) per mesh
        self.add_matte(kd=(0.5, 0.5, 0.5))  # default material 0 (api.rs)

    def _add_material(self, mtype, kd=(0, 0, 0), kr=(0, 0, 0), kt=(0, 0, 0), sigma=0.0,
                      rough_u=0.0, rough_v=0.0, eta=1.5, remap=True, opacity=(1, 1, 1),
                      ks=(0, 0, 0), eta3=(0.2, 0.92, 1.1), k3=(3.9, 2.45, 2.14)) -> int:
        """A material row with the JAX builder's defaults in the parameter
        slots the material does not set; returns its id."""
        p = np.zeros(sa.N_MAT_PARAMS, np.float32)
        p[sa.MP_KD:sa.MP_KD + 3] = kd
        p[sa.MP_KS:sa.MP_KS + 3] = ks
        p[sa.MP_KR:sa.MP_KR + 3] = kr
        p[sa.MP_KT:sa.MP_KT + 3] = kt
        p[sa.MP_ROUGH_U] = rough_u
        p[sa.MP_ROUGH_V] = rough_v
        p[sa.MP_ETA] = eta
        p[sa.MP_SIGMA] = sigma
        p[sa.MP_REMAP_ROUGH] = float(remap)
        p[sa.MP_ETA3:sa.MP_ETA3 + 3] = eta3
        p[sa.MP_K3:sa.MP_K3 + 3] = k3
        p[sa.MP_OPACITY:sa.MP_OPACITY + 3] = opacity
        p[sa.MP_BSSRDF] = -1
        self.mats.append((mtype, p, np.full(sa.N_TEX_SLOTS, -1, np.int32)))
        return len(self.mats) - 1

    def add_matte(self, kd=(0.5, 0.5, 0.5), sigma=0.0) -> int:
        """Matte material (materials/matte.rs): Lambert, Oren-Nayar for
        sigma > 0 (degrees)."""
        return self._add_material(sa.MATTE, kd=kd, sigma=sigma)

    def add_plastic(self, kd=(0.25,) * 3, ks=(0.25,) * 3, roughness=0.1, remap=True) -> int:
        """Plastic (materials/plastic.rs): Lambert and a dielectric
        TrowbridgeReitz gloss at eta 1.5."""
        return self._add_material(sa.PLASTIC, kd=kd, ks=ks, rough_u=roughness, rough_v=roughness,
                                  remap=remap)

    def add_metal(self, eta3=None, k3=None, roughness=0.01, remap=True) -> int:
        """Conductor (materials/metal.rs): TrowbridgeReitz with the conductor
        Fresnel term; eta3 and k3 default to measured copper resampled to
        RGB (metal.rs:12-121, utils/spectrum.copper_rgb)."""
        if eta3 is None or k3 is None:
            cu_eta, cu_k = spectrum.copper_rgb()
            eta3 = cu_eta if eta3 is None else eta3
            k3 = cu_k if k3 is None else k3
        return self._add_material(sa.METAL, eta3=eta3, k3=k3, rough_u=roughness,
                                  rough_v=roughness, remap=remap)

    def add_substrate(self, kd=(0.5,) * 3, ks=(0.5,) * 3, roughness=0.1, remap=True) -> int:
        """Substrate (materials/substrate.rs): FresnelBlend."""
        return self._add_material(sa.SUBSTRATE, kd=kd, ks=ks, rough_u=roughness,
                                  rough_v=roughness, remap=remap)

    def add_uber(self, kd=(0.25,) * 3, ks=(0.25,) * 3, kr=(0, 0, 0), kt=(0, 0, 0), roughness=0.1,
                 eta=1.5, opacity=(1, 1, 1), remap=True) -> int:
        """Uber (materials/uber.rs:142-257): Lambert, gloss, specular
        reflection and transmission, each scaled by the opacity, and the
        opacity's pass-through."""
        return self._add_material(sa.UBER, kd=kd, ks=ks, kr=kr, kt=kt, rough_u=roughness,
                                  rough_v=roughness, eta=eta, opacity=opacity, remap=remap)

    def add_translucent(self, kd=(0.25,) * 3, reflect=(0.5,) * 3, transmit=(0.5,) * 3) -> int:
        """Translucent (materials/translucent.rs): diffuse reflection and
        transmission scaled by reflect and transmit (the KR and KT slots)."""
        return self._add_material(sa.TRANSLUCENT, kd=kd, kr=reflect, kt=transmit)

    def add_disney(self, color=(0.5,) * 3, metallic=0.0, roughness=0.5, sheen=0.0,
                   clearcoat=0.0, eta=1.5, spec_tint=0.0, anisotropic=0.0, spec_trans=0.0,
                   clearcoat_gloss=1.0, sheen_tint=0.5, thin=False, flatness=0.0,
                   diff_trans=0.0) -> int:
        """The principled BSDF (materials/disney.rs:640), packed as the JAX
        builder packs it: MP_KS = (metallic, sheen, clearcoat); MP_OPACITY
        = (spec_tint, anisotropic, spec_trans); MP_KR = (clearcoat_gloss,
        sheen_tint, flatness); MP_KT = (thin, diff_trans, 0)."""
        return self._add_material(
            sa.DISNEY, kd=color, ks=(metallic, sheen, clearcoat),
            opacity=(spec_tint, anisotropic, spec_trans),
            kr=(clearcoat_gloss, sheen_tint, float(flatness)),
            kt=(float(bool(thin)), float(diff_trans), 0.0), rough_u=roughness,
            rough_v=roughness, eta=eta, remap=False)

    def add_fourier(self, bsdffile=None, table=None) -> int:
        """The tabulated BSDF (materials/fourier.rs): a SCATFUN file's table
        (ops/fourier_bsdf.read_bsdf_file, repacked), or a dense table
        (fourier_bsdf.make_fourier_table's dict).  One table a scene."""
        if table is None and bsdffile is not None:
            table = fb.make_fourier_table(fb.read_bsdf_file(bsdffile))
        if table is not None:
            self.fourier_table = table
        return self._add_material(sa.FOURIER)

    def add_mix(self, mat1: int, mat2: int, amount=(0.5,) * 3) -> int:
        """Mix (materials/mixmat.rs): mat1's two primary lobes scaled by
        amount and mat2's by 1 - amount, resolved at shading time.  Packing:
        MP_KD = amount, MP_KS[0:2] = the two material ids."""
        p = np.zeros(sa.N_MAT_PARAMS, np.float32)
        p[sa.MP_KD:sa.MP_KD + 3] = amount
        p[sa.MP_KS] = float(mat1)
        p[sa.MP_KS + 1] = float(mat2)
        p[sa.MP_BSSRDF] = -1
        self.mats.append((sa.MIXMAT, p, np.full(sa.N_TEX_SLOTS, -1, np.int32)))
        return len(self.mats) - 1

    def add_texture(self, tex_type, params=None, children=(-1, -1), world_to_texture=None,
                    image=None) -> int:
        """A texture row (textures/*.rs create functions), as the JAX
        builder packs it: params a dict of ops/texture TP_* column -> value
        (a sequence fills the columns from there) or a (16,) array, over the
        defaults su = sv = 1 and an image scale of 1; children the two child
        textures of a scale, mix, checker or dots; the transform's inverse
        maps world points into the 3D textures' space (the JAX builder
        takes world_to_texture.m_inv); image (H, W, 3) an image map's texels,
        its pyramid built at finalize.  Returns its id."""
        pvec = np.zeros(tx.N_TEX_PARAMS, np.float32)
        pvec[tx.TP_SU] = 1.0
        pvec[tx.TP_SV] = 1.0
        pvec[tx.TP_GAMMA_SCALE] = 1.0
        if isinstance(params, dict):
            for k, v in params.items():
                if hasattr(v, "__len__"):
                    pvec[k:k + len(v)] = v
                else:
                    pvec[k] = v
        elif params is not None:
            pvec[:len(params)] = params
        w2t = np.asarray(world_to_texture.m_inv if world_to_texture is not None else np.eye(4),
                         np.float32)
        self.textures.append((int(tex_type), pvec, np.asarray(children, np.int32), w2t, image))
        return len(self.textures) - 1

    def set_material_texture(self, mat_id: int, slot: int, tex_id: int):
        """Binds texture tex_id to a material's slot (arrays.TEX_SLOT_*)."""
        self.mats[mat_id][2][slot] = tex_id

    def add_mirror(self, kr=(0.9, 0.9, 0.9)) -> int:
        """Perfect mirror (materials/mirror.rs)."""
        return self._add_material(sa.MIRROR, kr=kr)

    def add_glass(self, kr=(1, 1, 1), kt=(1, 1, 1), eta=1.5, roughness=0.0,
                  remap=True) -> int:
        """Glass (materials/glass.rs): FresnelSpecular when smooth, else
        microfacet reflection and transmission of the given roughness."""
        return self._add_material(sa.GLASS, kr=kr, kt=kt, eta=eta, rough_u=roughness,
                                  rough_v=roughness, remap=remap)

    def add_hair(self, sigma_a=None, color=None, eumelanin=None, pheomelanin=None, eta=1.55,
                 beta_m=0.3, beta_n=0.3, alpha=2.0) -> int:
        """Hair (materials/hair.rs:28-126), its absorption resolved as
        HairMaterial::create does: sigma_a, else the color (MP_HAIR_MODE 1,
        converted at shading time), else the melanin concentrations, else
        eumelanin 1.3."""
        mode = 0.0
        if sigma_a is not None:
            kd = sigma_a
        elif color is not None:
            kd, mode = color, 1.0
        else:
            ce = 1.3 if (eumelanin is None and pheomelanin is None) else (eumelanin or 0.0)
            cp = pheomelanin or 0.0
            eu = np.array([0.419, 0.697, 1.37], np.float32)
            ph = np.array([0.187, 0.4, 1.05], np.float32)
            kd = tuple(ce * eu + cp * ph)
        return self._add_material(sa.HAIR, kd=kd, rough_u=beta_m, rough_v=beta_n, sigma=alpha,
                                  eta=eta, remap=False, opacity=(mode, 0.0, 0.0))

    def add_subsurface(self, sigma_a=None, sigma_s=None, name=None, scale=1.0, eta=1.33, g=0.0,
                       kr=(1.0,) * 3, kt=(1.0,) * 3, roughness=0.0, remap=True) -> int:
        """Subsurface material (materials/subsurface.rs): glass's surface
        lobes and a tabulated BSSRDF from the photon-beam-diffusion table
        (core/bssrdf.rs:569-682), folded along rho into per-channel radius
        profiles here (ops/bssrdf.make_material_tables).  sigma_a and
        sigma_s default to the reference's (whole milk's coefficients); the
        measured presets (``name``) are not ported yet."""
        if name is not None:
            raise NotImplementedError("measured subsurface presets are not ported yet "
                                      "(ROADMAP A18)")
        sigma_a = np.asarray((0.0011, 0.0024, 0.014) if sigma_a is None else sigma_a,
                             np.float32) * scale
        sigma_s = np.asarray((2.55, 3.21, 3.77) if sigma_s is None else sigma_s,
                             np.float32) * scale
        self.bssrdfs.append(bss.make_material_tables(sigma_a, sigma_s, g, eta))
        mid = self._add_material(sa.SUBSURFACE, kr=kr, kt=kt, eta=eta, rough_u=roughness,
                                 rough_v=roughness, remap=remap)
        self.mats[mid][1][sa.MP_BSSRDF] = len(self.bssrdfs) - 1
        return mid

    def add_medium(self, sigma_a=(1.0,) * 3, sigma_s=(1.0,) * 3, g=0.0, scale=1.0,
                   density_grid=None, medium_to_world: Optional[tr.Transform] = None) -> int:
        """A homogeneous or density-grid medium (media/homogeneous.rs,
        media/grid.rs, api.rs make_medium :953).  density_grid: (D, H, W)
        densities; medium_to_world places the unit cube the grid spans.
        Returns its id, for medium_interface= and camera_medium."""
        grid = None
        w2m = np.eye(4, dtype=np.float32)
        if density_grid is not None:
            grid = np.asarray(density_grid, np.float32)
            if medium_to_world is not None:
                w2m = np.asarray(medium_to_world.m_inv, np.float32)
        self.media.append((np.asarray(sigma_a, np.float32) * scale,
                           np.asarray(sigma_s, np.float32) * scale, float(g), grid, w2m))
        return len(self.media) - 1

    def add_triangle_mesh(self, indices, positions, normals=None, uvs=None, material: int = 0,
                          area_light=None, reverse_orientation: bool = False,
                          medium_interface=(-1, -1), alpha_tex: int = -1,
                          shadow_alpha_tex: int = -1) -> int:
        """World-space triangle mesh.  area_light: dict(L=(r,g,b),
        two_sided=bool, scale=(r,g,b)) makes every triangle emissive.
        medium_interface: the (inside, outside) medium ids, -1 vacuum.
        alpha_tex, shadow_alpha_tex: textures whose 0 at a hit's uv cuts the
        hit out of every ray, or of shadow rays (triangle.rs:313-327,
        :593-650); -1 none.  Returns the light id, or -1."""
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
        rows[:, [sa.TA_MED_IN, sa.TA_MED_OUT]] = medium_interface
        rows[:, [sa.TA_ALPHA, sa.TA_SALPHA]] = (alpha_tex, shadow_alpha_tex)
        self.tri_blocks.append(rows)
        self.n_tri_rows += n_tri
        return light_id

    def add_animated_triangle_mesh(self, indices, positions, object_to_world: tr.Transform,
                                   object_to_world_end: tr.Transform, normals=None, uvs=None,
                                   material: int = 0, reverse_orientation: bool = False):
        """A mesh moving between object_to_world at the shutter's open and
        object_to_world_end at its close (primitive.rs:198-265 with an
        AnimatedTransform): its rows stay in object space, and rays reach
        them through the inverse of the transform interpolated at each
        ray's time.  No area light, alpha mask or medium on it, as in the
        JAX package.  A transform that mirrors flips its orientation."""
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        P = np.asarray(positions, np.float32).reshape(-1, 3)
        m0 = np.asarray(object_to_world.m, np.float64)
        m1 = np.asarray(object_to_world_end.m, np.float64)
        T0, q0, S0 = an.decompose(m0)
        T1, q1, S1 = an.decompose(m1)
        if np.linalg.det(m0[:3, :3]) < 0:
            reverse_orientation = not reverse_orientation
        n_tri = len(idx)
        i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
        rows = np.zeros((n_tri, sa.N_TRI_ATTR), np.float32)
        rows[:, sa.TA_P0:sa.TA_P0 + 3] = P[i0]
        rows[:, sa.TA_P1:sa.TA_P1 + 3] = P[i1]
        rows[:, sa.TA_P2:sa.TA_P2 + 3] = P[i2]
        if normals is not None:
            N = np.asarray(normals, np.float32)
            rows[:, sa.TA_N0:sa.TA_N0 + 3] = N[i0]
            rows[:, sa.TA_N1:sa.TA_N1 + 3] = N[i1]
            rows[:, sa.TA_N2:sa.TA_N2 + 3] = N[i2]
            rows[:, sa.TA_HAS_N] = 1.0
        if uvs is not None:
            U = np.asarray(uvs, np.float32).reshape(-1, 2)
            rows[:, sa.TA_UV0:sa.TA_UV0 + 2] = U[i0]
            rows[:, sa.TA_UV1:sa.TA_UV1 + 2] = U[i1]
            rows[:, sa.TA_UV2:sa.TA_UV2 + 2] = U[i2]
        else:
            rows[:, sa.TA_UV1:sa.TA_UV1 + 2] = (1, 0)
            rows[:, sa.TA_UV2:sa.TA_UV2 + 2] = (1, 1)
        rows[:, sa.TA_MAT] = material
        rows[:, [sa.TA_LIGHT, sa.TA_MED_IN, sa.TA_MED_OUT, sa.TA_ALPHA, sa.TA_SALPHA]] = -1.0
        rows[:, sa.TA_REVERSE] = float(reverse_orientation)
        xf = np.concatenate([T0, q0, S0.ravel(), T1, q1, S1.ravel()]).astype(np.float32)
        self.anims.append((rows, xf))

    def add_prototype_mesh(self, indices, positions, normals=None, uvs=None,
                           material: int = 0) -> int:
        """A shared object-space mesh for add_instance (primitive.rs:198-265:
        one copy however many instances place it).  Returns its id."""
        F = np.asarray(indices, np.int64).reshape(-1, 3)
        P = np.asarray(positions, np.float32).reshape(-1, 3)
        rows = np.zeros((F.shape[0], sa.N_TRI_ATTR), np.float32)
        for k, col in enumerate((sa.TA_P0, sa.TA_P1, sa.TA_P2)):
            rows[:, col:col + 3] = P[F[:, k]]
        if normals is not None:
            N = np.asarray(normals, np.float32).reshape(-1, 3)
            for k, col in enumerate((sa.TA_N0, sa.TA_N1, sa.TA_N2)):
                rows[:, col:col + 3] = N[F[:, k]]
            rows[:, sa.TA_HAS_N] = 1.0
        if uvs is not None:
            U = np.asarray(uvs, np.float32).reshape(-1, 2)
            for k, col in enumerate((sa.TA_UV0, sa.TA_UV1, sa.TA_UV2)):
                rows[:, col:col + 2] = U[F[:, k]]
        else:
            rows[:, sa.TA_UV1] = 1.0
            rows[:, sa.TA_UV2:sa.TA_UV2 + 2] = 1.0
        rows[:, sa.TA_MAT] = material
        rows[:, [sa.TA_LIGHT, sa.TA_ALPHA, sa.TA_SALPHA]] = -1.0
        self.protos.append(rows)
        return len(self.protos) - 1

    def add_prototype_tris(self, tris: dict) -> int:
        """A prototype from per-triangle lists in object space (the JAX
        front end's ObjectInstance path: a dict of lists of arrays p0, p1,
        p2, n0, n1, n2, has_n, uv0, uv1, uv2, mat, reverse).  Returns its
        id."""
        cat = lambda k: np.concatenate(tris[k])
        p0 = cat("p0").astype(np.float32)
        rows = np.zeros((p0.shape[0], sa.N_TRI_ATTR), np.float32)
        for key, col, w in (("p0", sa.TA_P0, 3), ("p1", sa.TA_P1, 3), ("p2", sa.TA_P2, 3),
                            ("n0", sa.TA_N0, 3), ("n1", sa.TA_N1, 3), ("n2", sa.TA_N2, 3),
                            ("uv0", sa.TA_UV0, 2), ("uv1", sa.TA_UV1, 2), ("uv2", sa.TA_UV2, 2)):
            rows[:, col:col + w] = cat(key)
        rows[:, sa.TA_HAS_N] = cat("has_n").astype(np.float32)
        rows[:, sa.TA_MAT] = cat("mat").astype(np.float32)
        rows[:, sa.TA_REVERSE] = cat("reverse").astype(np.float32)
        rows[:, [sa.TA_LIGHT, sa.TA_ALPHA, sa.TA_SALPHA]] = -1.0
        self.protos.append(rows)
        return len(self.protos) - 1

    def add_instance(self, proto_id: int, object_to_world: Optional[tr.Transform] = None,
                     material: int = -1):
        """Places prototype proto_id by object_to_world; material >= 0
        overrides the prototype's."""
        o2w = object_to_world or tr.identity()
        self.instances.append((proto_id, np.asarray(o2w.m, np.float32), material))

    def _motion_tables(self) -> dict:
        """arrays.motion_fields' tables, as the JAX finalize packs them: the
        prototypes only where an instance places one."""
        out = sa.empty_motion_tables()
        if self.instances:
            offs = np.cumsum([0] + [len(r) for r in self.protos])
            o2w = np.stack([i[1] for i in self.instances])
            out.update(proto_attr=np.concatenate(self.protos),
                       proto_range=np.stack([offs[:-1], offs[1:]], -1).astype(np.int32),
                       inst_o2w=o2w,
                       inst_w2o=np.linalg.inv(o2w.astype(np.float64)).astype(np.float32),
                       inst_proto=np.asarray([i[0] for i in self.instances], np.int32),
                       inst_mat=np.asarray([i[2] for i in self.instances], np.int32),
                       n_proto_tris=int(offs[-1]))
        if self.anims:
            offs = np.cumsum([0] + [len(r) for r, _ in self.anims])
            out.update(anim_attr=np.concatenate([r for r, _ in self.anims]),
                       anim_range=np.stack([offs[:-1], offs[1:]], -1).astype(np.int32),
                       anim_xf=np.stack([xf for _, xf in self.anims]), n_anim_tris=int(offs[-1]))
        return out

    def add_sphere(self, object_to_world: Optional[tr.Transform] = None, radius=1.0, z_min=None,
                   z_max=None, phi_max=360.0, material: int = 0, area_light=None,
                   reverse_orientation: bool = False, medium_interface=(-1, -1)) -> int:
        """Analytic (partial) sphere (shapes/sphere.rs) in object space under
        object_to_world.  area_light: dict(L=(r,g,b), two_sided=bool,
        scale=(r,g,b)) makes it a diffuse area light.  medium_interface: the
        (inside, outside) medium ids.  Returns the light id, or -1."""
        o2w = object_to_world or tr.identity()
        z_min = -radius if z_min is None else z_min
        z_max = radius if z_max is None else z_max
        # the full sphere's area in world units, the o2w uniform scale folded in
        area = lambda scale: 4.0 * np.pi * (radius * scale) ** 2
        return self._add_quadric(o2w, sa.QK_SPHERE, (radius, z_min, z_max, np.deg2rad(phi_max)),
                                 material, area_light, sa.ALG_SPHERE, area, reverse_orientation,
                                 medium_interface)

    def add_cylinder(self, object_to_world: Optional[tr.Transform] = None, radius=1.0,
                     z_min=-1.0, z_max=1.0, phi_max=360.0, material: int = 0, area_light=None,
                     reverse_orientation: bool = False, medium_interface=(-1, -1)) -> int:
        """Analytic (partial) cylinder about z (shapes/cylinder.rs), its
        arguments as add_sphere's.  Returns the light id, or -1."""
        area = lambda scale: (z_max - z_min) * radius * np.deg2rad(phi_max) * scale * scale
        return self._add_quadric(object_to_world or tr.identity(), sa.QK_CYLINDER,
                                 (radius, z_min, z_max, np.deg2rad(phi_max)), material,
                                 area_light, sa.ALG_CYLINDER, area, reverse_orientation,
                                 medium_interface)

    def add_disk(self, object_to_world: Optional[tr.Transform] = None, height=0.0, radius=1.0,
                 inner_radius=0.0, phi_max=360.0, material: int = 0, area_light=None,
                 reverse_orientation: bool = False, medium_interface=(-1, -1)) -> int:
        """Analytic disk or annulus in the plane z = height, facing +z
        (shapes/disk.rs), its other arguments as add_sphere's.  Returns the
        light id, or -1."""
        area = lambda scale: (0.5 * np.deg2rad(phi_max)
                              * (radius * radius - inner_radius * inner_radius) * scale * scale)
        return self._add_quadric(object_to_world or tr.identity(), sa.QK_DISK,
                                 (radius, inner_radius, height, np.deg2rad(phi_max)), material,
                                 area_light, sa.ALG_DISK, area, reverse_orientation,
                                 medium_interface)

    def _add_quadric(self, o2w, kind, params, material, area_light, geom, area,
                     reverse_orientation, medium_interface) -> int:
        """A quadric row of `kind` and its params, and with area_light its
        diffuse area light of geometry `geom`, whose world area is
        area(scale) for the o2w scale (the norm of its first column).
        Returns the light id, or -1."""
        light_id = -1
        if area_light is not None:
            scale = float(np.linalg.norm(np.asarray(o2w.m, np.float32)[:3, 0]))
            lp = np.zeros(sa.N_LIGHT_PARAMS, np.float32)
            lp[sa.LP_I:sa.LP_I + 3] = (np.asarray(area_light.get("L", (1, 1, 1)), np.float32)
                                       * np.asarray(area_light.get("scale", (1, 1, 1)), np.float32))
            lp[sa.LP_TWO_SIDED] = float(area_light.get("two_sided", False))
            lp[sa.LP_AREA] = area(scale)
            self.lights.append(dict(type=sa.LIGHT_AREA, params=lp, geom=geom, tri_start=0,
                                    tri_end=0, shape_idx=len(self.sph_rows), tri_areas=None))
            light_id = len(self.lights) - 1
        row = np.zeros(sa.N_SPH_ATTR, np.float32)
        row[sa.SP_O2W:sa.SP_O2W + 16] = np.asarray(o2w.m, np.float32).reshape(16)
        row[sa.SP_W2O:sa.SP_W2O + 16] = np.asarray(o2w.m_inv, np.float32).reshape(16)
        row[sa.SP_PARAMS:sa.SP_PARAMS + 4] = params
        row[sa.SP_MAT] = material
        row[sa.SP_LIGHT] = light_id
        row[sa.SP_REVERSE] = float(reverse_orientation)
        row[[sa.SP_MED_IN, sa.SP_MED_OUT]] = medium_interface
        row[sa.SP_KIND] = kind
        self.sph_rows.append(row)
        return light_id

    def add_infinite_light(self, radiance_map=None, L=(1, 1, 1), scale=(1, 1, 1),
                           light_to_world: Optional[tr.Transform] = None) -> int:
        """An infinite light (lights/infinite.rs): an equirect radiance map
        (H, W, 3), rows from +z (theta 0) down, columns phi from +x, times L
        and scale, under light_to_world; a constant 2x2 map of L without
        one.  The scene holds one map: a later call's replaces an earlier
        one's, as in the JAX builder.  Returns its light id."""
        if radiance_map is None:
            radiance_map = np.ones((2, 2, 3), np.float32)
        rad = (np.asarray(radiance_map, np.float32)
               * (np.asarray(L, np.float32) * np.asarray(scale, np.float32)))
        l2w = light_to_world or tr.identity()
        self.env = (rad, np.asarray(l2w.m, np.float32), np.asarray(l2w.m_inv, np.float32))
        self.lights.append(dict(type=sa.LIGHT_INFINITE, params=np.zeros(sa.N_LIGHT_PARAMS,
                                                                       np.float32),
                                geom=sa.ALG_NONE, tri_start=0, tri_end=0, shape_idx=0,
                                tri_areas=None))
        return len(self.lights) - 1

    def _add_area_light_tri(self, P, idx, L=(1, 1, 1), two_sided=False, scale=(1, 1, 1)) -> int:
        areas = np.zeros(len(idx), np.float32)
        for k, (i0, i1, i2) in enumerate(idx):
            areas[k] = 0.5 * np.linalg.norm(np.cross(P[i1] - P[i0], P[i2] - P[i0]))
        lp = np.zeros(sa.N_LIGHT_PARAMS, np.float32)
        lp[sa.LP_I:sa.LP_I + 3] = np.asarray(L, np.float32) * np.asarray(scale, np.float32)
        lp[sa.LP_TWO_SIDED] = float(two_sided)
        lp[sa.LP_AREA] = float(areas.sum())
        self.lights.append(dict(type=sa.LIGHT_AREA, params=lp, geom=sa.ALG_TRI_RANGE,
                                tri_start=self.n_tri_rows, tri_end=self.n_tri_rows + len(idx),
                                shape_idx=0, tri_areas=areas))
        return len(self.lights) - 1

    def add_curve(self, cps, width=1.0, width0=None, width1=None, curve_type="flat",
                  normals=None, splitdepth=3, material: int = 0,
                  object_to_world: Optional[tr.Transform] = None) -> int:
        """Cubic Bézier curves (shapes/curve.rs create_curve_shape :556): cps
        (4, 3) or (N, 4, 3) control points in object space, flattened to
        segments at once (ops/curves.flatten_curves); normals (N, 2, 3) the
        ribbons' end normals.  Returns the segment count."""
        cps = np.asarray(cps, np.float32).reshape(-1, 4, 3)
        n = cps.shape[0]
        if object_to_world is not None:
            m = np.asarray(object_to_world.m, np.float32)
            cps = cps @ m[:3, :3].T + m[:3, 3]
        w0 = np.full(n, width if width0 is None else width0, np.float32)
        w1 = np.full(n, width if width1 is None else width1, np.float32)
        ctype = {"flat": cv.FLAT, "cylinder": cv.CYLINDER, "ribbon": cv.RIBBON}[curve_type]
        n0 = n1 = None
        if normals is not None:
            nn = np.asarray(normals, np.float32).reshape(-1, 2, 3)
            if object_to_world is not None:
                minv_t = np.linalg.inv(np.asarray(object_to_world.m, np.float32)[:3, :3]).T
                nn = nn @ minv_t.T
            n0, n1 = nn[:, 0], nn[:, 1]
        arrs = cv.flatten_curves(cps, w0, w1, np.full(n, ctype, np.int32), n0, n1,
                                 splitdepth=splitdepth)
        rows = cv.pack_curve_attr(arrs, np.full(arrs["crv_cp"].shape[0], material, np.int32))
        self.curves.append(rows)
        return rows.shape[0]

    def _add_delta_light(self, ltype, I, scale, P, extra=None) -> int:
        lp = np.zeros(sa.N_LIGHT_PARAMS, np.float32)
        lp[sa.LP_P:sa.LP_P + 3] = P
        lp[sa.LP_I:sa.LP_I + 3] = np.asarray(I, np.float32) * np.asarray(scale, np.float32)
        for k, v in (extra or {}).items():
            lp[k] = v
        self.lights.append(dict(type=ltype, params=lp, geom=sa.ALG_NONE, tri_start=0, tri_end=0,
                                shape_idx=0, tri_areas=None))
        return len(self.lights) - 1

    def add_point_light(self, p=(0, 0, 0), I=(1, 1, 1), scale=(1, 1, 1)) -> int:
        """An isotropic point light (lights/point.rs) of intensity I at p."""
        return self._add_delta_light(sa.LIGHT_POINT, I, scale, p)

    def add_spot_light(self, p=(0, 0, 0), to=(0, 0, 1), I=(1, 1, 1), cone_angle=30.0,
                       cone_delta=5.0, scale=(1, 1, 1)) -> int:
        """A spot light (lights/spot.rs) at p aimed at `to`: full intensity
        within cone_angle - cone_delta degrees, falling off to 0 at
        cone_angle.  Its direction rides the world-center slot."""
        d = np.asarray(to, np.float64) - np.asarray(p, np.float64)
        li = self._add_delta_light(sa.LIGHT_SPOT, I, scale, p, {
            sa.LP_COS_TOTAL: np.cos(np.deg2rad(cone_angle)),
            sa.LP_COS_FALLOFF: np.cos(np.deg2rad(cone_angle - cone_delta))})
        self.lights[li]["spot_dir"] = (d / np.linalg.norm(d)).astype(np.float32)
        return li

    def add_projection_light(self, p=(0, 0, 0), to=(0, 0, 1), I=(1, 1, 1), fov=45.0, image=None,
                             scale=(1, 1, 1)) -> int:
        """A projection light (lights/projection.rs) at p aimed at `to`: a
        point light through the image (H, W, 3) on a square window of fov
        degrees (a 4x4 white image without one), its own image-map texture.
        Its direction rides the world-center slot."""
        if image is None:
            image = np.ones((4, 4, 3), np.float32)
        tex = self.add_texture(tx.TEX_IMAGEMAP, image=image)
        d = np.asarray(to, np.float64) - np.asarray(p, np.float64)
        li = self._add_delta_light(sa.LIGHT_PROJECTION, I, scale, p, {
            sa.LP_TEX: tex, sa.LP_TAN_FOV: np.tan(np.deg2rad(fov) / 2)})
        self.lights[li]["spot_dir"] = (d / np.linalg.norm(d)).astype(np.float32)
        return li

    def add_gonio_light(self, p=(0, 0, 0), to=(0, 0, 1), I=(1, 1, 1), image=None,
                        scale=(1, 1, 1)) -> int:
        """A goniometric light (lights/gonio.rs) at p: a point light scaled
        by the equirect map image (H, W, 3) of the directions about `to` (a
        4x8 white map without one), its own image-map texture."""
        if image is None:
            image = np.ones((4, 8, 3), np.float32)
        tex = self.add_texture(tx.TEX_IMAGEMAP, image=image)
        d = np.asarray(to, np.float64) - np.asarray(p, np.float64)
        li = self._add_delta_light(sa.LIGHT_GONIO, I, scale, p, {sa.LP_TEX: tex})
        self.lights[li]["spot_dir"] = (d / np.linalg.norm(d)).astype(np.float32)
        return li

    def add_distant_light(self, from_p=(0, 0, 0), to=(0, 0, 1), L=(1, 1, 1),
                          scale=(1, 1, 1)) -> int:
        """A distant light (lights/distant.rs) of radiance L arriving from
        from_p - to; the position slot holds that direction."""
        w = np.asarray(from_p, np.float64) - np.asarray(to, np.float64)
        return self._add_delta_light(sa.LIGHT_DISTANT, L, scale,
                                     (w / np.linalg.norm(w)).astype(np.float32))

    def _world_bound(self, tri_attr, sph_attr, crv_attr, motion):
        """Center and radius of the bound over every vertex, every
        quadric's transformed center +- its scaled bounding radius, every
        instance's transformed prototype box, every curve segment's box and
        every animated mesh's motion bound (arrays.finalize_scene).
        motion: _motion_tables()."""
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
        if len(motion["inst_o2w"]):
            pa = motion["proto_attr"]
            pp = np.stack([pa[:, c:c + 3] for c in (sa.TA_P0, sa.TA_P1, sa.TA_P2)])
            pr = np.asarray(motion["proto_range"], np.int64)
            plo = np.stack([pp[:, a:b].min((0, 1)) for a, b in pr])  # (P, 3)
            phi = np.stack([pp[:, a:b].max((0, 1)) for a, b in pr])
            ip = np.asarray(motion["inst_proto"], np.int64)
            lo, hi = plo[ip], phi[ip]
            corners = np.stack(
                [np.stack([np.where(m & 1, hi[:, 0], lo[:, 0]),
                           np.where(m & 2, hi[:, 1], lo[:, 1]),
                           np.where(m & 4, hi[:, 2], lo[:, 2])], -1)
                 for m in range(8)], 1)  # (I, 8, 3)
            R3 = motion["inst_o2w"][:, :3, :3]
            t3 = motion["inst_o2w"][:, :3, 3]
            wc = np.einsum("ikj,icj->ick", R3, corners) + t3[:, None, :]
            pts += [wc.min(1).astype(np.float32), wc.max(1).astype(np.float32)]
        if crv_attr is not None:
            pts += list(cv.segment_boxes(crv_attr))
        if motion["n_anim_tris"]:
            # the motion bound over the whole shutter (transform.rs:2207-2281)
            aa = motion["anim_attr"]
            for (a, b), xf in zip(motion["anim_range"], motion["anim_xf"]):
                vv = np.concatenate([aa[a:b, c:c + 3] for c in (sa.TA_P0, sa.TA_P1, sa.TA_P2)])
                lo, hi = an.motion_bounds(*(np.asarray(x) for x in (
                    xf[0:3], xf[3:7], xf[7:16], xf[16:19], xf[19:23], xf[23:32])), vv)
                pts += [lo[None], hi[None]]
        if not pts:
            return np.zeros(3, np.float32), 1.0
        allp = np.concatenate(pts, 0)
        lo, hi = allp.min(0), allp.max(0)
        center = 0.5 * (lo + hi)
        return center, float(np.linalg.norm(hi - center)) + 1e-6

    def _media_tables(self) -> dict:
        """The media's numpy tables as the JAX finalize stacks them: the
        grids padded with 0 to the largest, a homogeneous medium's grid all
        ones, max densities at least 1e-6; one unused row without media."""
        if not self.media:
            return dict(med_sigma_a=np.zeros((1, 3), np.float32),
                        med_sigma_s=np.zeros((1, 3), np.float32), med_g=np.zeros(1, np.float32),
                        med_grid=np.ones((1, 1, 1, 1), np.float32),
                        med_w2m=np.eye(4, dtype=np.float32)[None],
                        med_max_density=np.ones(1, np.float32), camera_medium=self.camera_medium)
        grids = [m[3] for m in self.media]
        dims = [(g.shape if g is not None else (1, 1, 1)) for g in grids]
        D, H, W = (max(dd[k] for dd in dims) for k in range(3))
        gstack = np.ones((len(self.media), D, H, W), np.float32)
        maxd = np.ones(len(self.media), np.float32)
        for i, g in enumerate(grids):
            if g is not None:
                gstack[i] = 0.0
                gstack[i, :g.shape[0], :g.shape[1], :g.shape[2]] = g
                maxd[i] = float(g.max())
        return dict(med_sigma_a=np.stack([m[0] for m in self.media]),
                    med_sigma_s=np.stack([m[1] for m in self.media]),
                    med_g=np.asarray([m[2] for m in self.media], np.float32), med_grid=gstack,
                    med_w2m=np.stack([m[4] for m in self.media]),
                    med_max_density=np.maximum(maxd, 1e-6), camera_medium=self.camera_medium)

    def _bssrdf_tables(self) -> tuple:
        """(profile, cdf, rho_eff, sigma_t, eta) stacked over the subsurface
        materials (0 rows without one)."""
        t = self.bssrdfs
        if not t:
            return (np.zeros((0, 3, bss.N_RADIUS), np.float32),) * 2 + (np.zeros((0, 3)),) * 2 + (
                np.zeros(0),)
        return (np.stack([x["profile"] for x in t]), np.stack([x["cdf"] for x in t]),
                np.stack([x["rho_eff"] for x in t]), np.stack([x["sigma_t"] for x in t]),
                np.asarray([x["eta"] for x in t], np.float32))

    def _texture_tables(self) -> dict:
        """The texture tables as the JAX finalize packs them
        (builder.py:839-877): every image's pyramid (ops/mipmap.py) stacked
        into one atlas, one rect per (texture, level), the widest level
        setting its width."""
        if not self.textures:
            return sa.empty_texture_tables()
        X = len(self.textures)
        out = dict(tex_type=np.asarray([t[0] for t in self.textures], np.int32),
                   tex_params=np.stack([t[1] for t in self.textures]),
                   tex_child=np.stack([t[2] for t in self.textures]),
                   tex_w2t=np.stack([t[3] for t in self.textures]),
                   tex_atlas=np.zeros((1, 1, 3), np.float32))
        imgs = [(i, t[4]) for i, t in enumerate(self.textures) if t[4] is not None]
        rects = np.zeros((X, 4), np.int32)
        mips = np.zeros((X, mm.MAX_LEVELS, 3), np.int32)
        nlv = np.zeros(X, np.int32)
        if imgs:
            wrap = lambda i: int(self.textures[i][1][tx.TP_WRAP])
            pyramids = {i: mm.build_pyramid(np.asarray(im)[..., :3], wrap(i)) for i, im in imgs}
            aw = max(lv.shape[1] for p in pyramids.values() for lv in p)
            ah = sum(lv.shape[0] for p in pyramids.values() for lv in p)
            atlas = np.zeros((ah, aw, 3), np.float32)
            y = 0
            for i, _ in imgs:
                for li, lv in enumerate(pyramids[i]):
                    h, w = lv.shape[:2]
                    atlas[y:y + h, :w] = lv
                    mips[i, li] = (y, h, w)
                    if li == 0:
                        rects[i] = (y, h, w, wrap(i))
                    y += h
                nlv[i] = len(pyramids[i])
            out["tex_atlas"] = atlas
        out.update(tex_rect=rects, tex_mip=mips, tex_nlv=nlv)
        return out

    def finalize(self, device="cuda") -> sa.Scene:
        dev = resolve(device)
        n_tri, n_l, n_sph = self.n_tri_rows, len(self.lights), len(self.sph_rows)
        tri_attr = (np.concatenate(self.tri_blocks) if n_tri
                    else np.zeros((1, sa.N_TRI_ATTR), np.float32))
        sph_attr = (np.stack(self.sph_rows) if n_sph
                    else np.zeros((1, sa.N_SPH_ATTR), np.float32))
        crv_attr = np.concatenate(self.curves) if self.curves else None
        motion = self._motion_tables()
        center, radius = self._world_bound(tri_attr, sph_attr, crv_attr, motion)

        mat_attr = np.zeros((len(self.mats), sa.N_MAT_ATTR), np.float32)
        for i, (mtype, p, tex) in enumerate(self.mats):
            mat_attr[i, sa.MA_TYPE] = mtype
            mat_attr[i, sa.MA_PARAMS:sa.MA_PARAMS + sa.N_MAT_PARAMS] = p
            mat_attr[i, sa.MA_TEX:sa.MA_TEX + sa.N_TEX_SLOTS] = tex

        max_range = max([l["tri_end"] - l["tri_start"] for l in self.lights] + [1])
        light_attr = np.zeros((max(n_l, 1), sa.N_LIGHT_ATTR), np.float32)
        cdf = np.zeros((n_l, max_range + 1), np.float32)
        flags = {sa.LIGHT_POINT: sa.LF_DELTA_POSITION, sa.LIGHT_SPOT: sa.LF_DELTA_POSITION,
                 sa.LIGHT_PROJECTION: sa.LF_DELTA_POSITION, sa.LIGHT_GONIO: sa.LF_DELTA_POSITION,
                 sa.LIGHT_DISTANT: sa.LF_DELTA_DIRECTION, sa.LIGHT_AREA: sa.LF_AREA,
                 sa.LIGHT_INFINITE: sa.LF_INFINITE}
        for li, l in enumerate(self.lights):
            lp = l["params"].copy()
            lp[sa.LP_WORLD_RADIUS] = radius
            # a spot's direction rides the world-center slot
            lp[sa.LP_WORLD_CENTER:sa.LP_WORLD_CENTER + 3] = l.get("spot_dir", center)
            light_attr[li, :sa.N_LIGHT_PARAMS] = lp
            light_attr[li, sa.LA_TYPE] = l["type"]
            light_attr[li, sa.LA_FLAGS] = flags[l["type"]]
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
        types = [l["type"] for l in self.lights]
        # the infinite light's power takes the map's mean over its channels
        env_total = float(np.mean(self.env[0])) * 3 if self.env is not None else 0.0
        power = (compute_light_power(np.asarray(types), light_attr[:n_l, :sa.N_LIGHT_PARAMS],
                                     env_total) if n_l else np.ones(0, np.float32))
        env = self.env or (np.zeros((1, 1, 3), np.float32), np.eye(4, dtype=np.float32),
                           np.eye(4, dtype=np.float32))
        geoms = [l["geom"] for l in self.lights]

        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        fou = self.fourier_table
        tex = self._texture_tables()
        return sa.Scene(
            tri_attr=f32(tri_attr), mat_attr=f32(mat_attr), light_attr=f32(light_attr),
            light_power=f32(power), alight_tri_cdf=f32(cdf), world_center=f32(center),
            world_radius=float(np.float32(radius)), n_tris=n_tri, n_lights=n_l,
            sph_attr=f32(sph_attr), n_spheres=n_sph,
            quad_kind_mask=sa.type_mask([r[sa.SP_KIND] for r in self.sph_rows]),
            light_type_mask=sa.type_mask(types),
            has_sphere_lights=sa.ALG_SPHERE in geoms,
            has_quadric_lights=sa.ALG_CYLINDER in geoms or sa.ALG_DISK in geoms,
            crv_attr=None if crv_attr is None else f32(crv_attr),
            n_curve_segs=0 if crv_attr is None else crv_attr.shape[0],
            has_hair=any(m[0] == sa.HAIR for m in self.mats),
            has_alpha=bool((tri_attr[:n_tri, [sa.TA_ALPHA, sa.TA_SALPHA]] >= 0).any()),
            has_rough_glass=sa.rough_glass(mat_attr),
            mat_kind_mask=sa.type_mask([m[0] for m in self.mats]),
            tex_slot_mask=sa.slot_mask(mat_attr),
            **sa.texture_fields(tex, sa.texture_kind_mask(tex["tex_type"], mat_attr), dev),
            **sa.motion_fields(device=dev, **motion),
            **sa.media_fields(device=dev, **self._media_tables()),
            has_media=sa.media_present(tri_attr, n_tri, sph_attr, n_sph, self.camera_medium),
            **sa.bssrdf_fields(*self._bssrdf_tables(), dev),
            **sa.env_fields(*env, types, dev),
            **(sa.fourier_fields(*(fou[k] for k in ("mu", "dense", "m", "cdf", "a0", "eta")), dev)
               if fou is not None else {}),
        )
