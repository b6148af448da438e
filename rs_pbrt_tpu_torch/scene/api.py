"""pbrt API state machine: statements -> SceneBuilder -> render config.

The port's copy of the JAX package's ``scene/api.py`` (reference
src/core/api.rs): the graphics state stack, the current transform (a
start and an end matrix for motion), named materials, textures, media and
coordinate systems, object instancing and the make_* factories.  It reads
parser.Statement streams, drives the port's own SceneBuilder, cameras,
sampler, filter and RenderCfg, and gives (Scene, Camera, RenderCfg,
SamplerCfg, FilterCfg, output name), the scene and camera on the device
asked for.  Host Python and numpy until ``finish`` makes the tensors.

An ObjectInstance flattens its object's shapes through the instance's
transform, or, where the copies would exceed FLATTEN_INSTANCE_LIMIT
triangles, places one object-space prototype per use (the two-level
walk, ops/instancing.py).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from ..io.floatfile import read_float_file
from ..io.image import read_image
from ..io.measured_ss import get_medium_scattering_properties
from ..io.nurbs import tessellate_nurbs
from ..io.plyloader import load_ply
from ..io.subdiv import loop_subdivide
from ..models import cameras as cam
from ..models import samplers as smpl
from ..models.integrators import render as rdr
from ..ops import film as filmmod
from ..ops import texture as tx
from ..utils import transform as tr
from ..utils.spectrum import copper_rgb
from . import arrays as sa
from . import parser as ps
from .builder import SceneBuilder


@dataclass
class GraphicsState:
    """reference api.rs:568 GraphicsState."""

    material: int = 0
    named_materials: dict = field(default_factory=dict)
    area_light: Optional[dict] = None
    reverse_orientation: bool = False
    material_params: Optional[dict] = None
    material_type: str = "matte"
    # (inside, outside) named-medium ids; -1 = vacuum (reference
    # api.rs pbrt_medium_interface + GraphicsState current media)
    medium_interface: tuple = (-1, -1)


def _mat4(vals):
    # pbrt matrices are column-major in the file
    return np.asarray(vals, np.float32).reshape(4, 4).T


class PbrtAPI:
    """reference pbrt_init/pbrt_* statement functions api.rs:2327-3050."""

    def __init__(self, search_dir: Optional[Path] = None):
        self.builder = SceneBuilder()
        self.ctm = np.eye(4, dtype=np.float32)
        # end-of-shutter CTM (reference TransformSet api.rs:163 keeps a
        # start/end pair; ActiveTransform selects which ops update)
        self.ctm_end = np.eye(4, dtype=np.float32)
        self.active = "all"  # "all" | "start" | "end"
        self.transform_times = (0.0, 1.0)
        self.transform_stack = []
        self.gs = GraphicsState()
        self.gs_stack = []
        self.named_coord_systems = {}
        self.world_to_camera = None
        self.in_world = False
        self.search_dir = search_dir
        # render options (reference RenderOptions api.rs:179)
        self.integrator_name = "path"
        self.integrator_params = {}
        self.camera_name = "perspective"
        self.camera_params = {}
        self.camera_to_world = np.eye(4, dtype=np.float32)
        self.camera_to_world_end = np.eye(4, dtype=np.float32)
        self.accelerator_name = "bvh"
        self.sampler_name = "halton"
        self.sampler_params = {}
        self.filter_name = "box"
        self.filter_params = {}
        self.film_params = {}
        self.textures = {}  # name -> ("constant"/"imagemap"..., value)
        self.named_media = {}  # name -> medium id (MakeNamedMedium)
        self.objects = {}  # ObjectBegin name -> list of deferred shape stmts
        self.current_object = None
        self.instance_uses = []  # (object name, use-time CTM) pairs
        self.output_name = "pbrt.png"

    # ---- transforms ----

    def _apply(self, m):
        if self.active in ("all", "start"):
            self.ctm = self.ctm @ m
        if self.active in ("all", "end"):
            self.ctm_end = self.ctm_end @ m

    def do_statement(self, st: ps.Statement):
        name = st.name
        h = getattr(self, f"_st_{name.lower()}", None)
        if h is None:
            print(f"WARNING: unhandled statement {name}")
            return
        h(st)

    def _st_lookat(self, st):
        e, l, u = st.args[0:3], st.args[3:6], st.args[6:9]
        t = tr.look_at(e, l, u)
        # pbrt: CTM = CTM * world_to_camera
        self._apply(np.asarray(t.m_inv))

    def _st_translate(self, st):
        self._apply(np.asarray(tr.translate(st.args).m))

    def _st_scale(self, st):
        self._apply(np.asarray(tr.scale(*st.args).m))

    def _st_rotate(self, st):
        self._apply(np.asarray(tr.rotate(st.args[0], st.args[1:4]).m))

    def _st_transform(self, st):
        if self.active in ("all", "start"):
            self.ctm = _mat4(st.args)
        if self.active in ("all", "end"):
            self.ctm_end = _mat4(st.args)

    def _st_concattransform(self, st):
        self._apply(_mat4(st.args))

    def _st_identity(self, st):
        if self.active in ("all", "start"):
            self.ctm = np.eye(4, dtype=np.float32)
        if self.active in ("all", "end"):
            self.ctm_end = np.eye(4, dtype=np.float32)

    def _st_coordinatesystem(self, st):
        self.named_coord_systems[st.args[0]] = self.ctm.copy()

    def _st_coordsystransform(self, st):
        if st.args[0] in self.named_coord_systems:
            self.ctm = self.named_coord_systems[st.args[0]].copy()
            self.ctm_end = self.ctm.copy()

    def _st_transformbegin(self, st):
        self.transform_stack.append((self.ctm.copy(), self.ctm_end.copy()))

    def _st_transformend(self, st):
        self.ctm, self.ctm_end = self.transform_stack.pop()

    def _st_activetransform(self, st):
        which = st.args[0] if st.args else "All"
        self.active = {"StartTime": "start", "EndTime": "end"}.get(which, "all")

    def _st_transformtimes(self, st):
        self.transform_times = (float(st.args[0]), float(st.args[1]))

    # ---- pre-world config ----

    def _st_camera(self, st):
        self.camera_name = st.args[0]
        self.camera_params = st.params
        # world-to-camera = CTM; camera-to-world = inverse
        self.camera_to_world = np.linalg.inv(self.ctm.astype(np.float64)).astype(
            np.float32
        )
        self.camera_to_world_end = np.linalg.inv(
            self.ctm_end.astype(np.float64)
        ).astype(np.float32)
        # the camera sits in the current exterior medium (reference
        # api.rs pbrt_camera: camera_medium = current outside medium)
        self.builder.camera_medium = self.gs.medium_interface[1]
        self.named_coord_systems["camera"] = self.ctm.copy()

    def _st_sampler(self, st):
        self.sampler_name = st.args[0]
        self.sampler_params = st.params

    def _st_film(self, st):
        self.film_params = st.params
        self.output_name = ps.find_string(st.params, "filename", "pbrt.png")

    def _st_pixelfilter(self, st):
        self.filter_name = st.args[0]
        self.filter_params = st.params

    def _st_integrator(self, st):
        self.integrator_name = st.args[0]
        self.integrator_params = st.params

    def _st_accelerator(self, st):
        # "bvh" (default, api.rs:528) or "kdtree"; consumed by
        # build_accel(scene, kind=cfg.accelerator)
        self.accelerator_name = st.args[0]

    # ---- world ----

    def _st_worldbegin(self, st):
        self.in_world = True
        self.ctm = np.eye(4, dtype=np.float32)
        self.ctm_end = np.eye(4, dtype=np.float32)
        self.active = "all"
        self.named_coord_systems["world"] = self.ctm.copy()

    def _st_worldend(self, st):
        self._resolve_instances()
        self.instance_uses = []

    def _st_attributebegin(self, st):
        self.gs_stack.append(copy.deepcopy(self.gs))
        self.transform_stack.append((self.ctm.copy(), self.ctm_end.copy()))

    def _st_attributeend(self, st):
        self.gs = self.gs_stack.pop()
        self.ctm, self.ctm_end = self.transform_stack.pop()

    def _st_reverseorientation(self, st):
        self.gs.reverse_orientation = not self.gs.reverse_orientation

    # ---- materials & textures ----

    def _texture_or_const(self, params, name, default):
        """Constant value for the material factory; textured slots are
        bound to the device texture table afterwards (_bind_texture_slots),
        which overrides the constant at shade time (ops/bsdf.make_bsdf_at)."""
        if name in params and params[name][0] == "texture":
            return default
        return ps.find_spectrum(params, name, default)

    # (pbrt param name, material texture slot) bindings
    _TEX_SLOTS = (
        ("Kd", "TEX_SLOT_KD"), ("color", "TEX_SLOT_KD"), ("Ks", "TEX_SLOT_KS"),
        ("Kr", "TEX_SLOT_KR"), ("Kt", "TEX_SLOT_KT"), ("sigma", "TEX_SLOT_SIGMA"),
        ("roughness", "TEX_SLOT_ROUGH_U"), ("uroughness", "TEX_SLOT_ROUGH_U"),
        ("vroughness", "TEX_SLOT_ROUGH_V"), ("opacity", "TEX_SLOT_OPACITY"),
        ("bumpmap", "TEX_SLOT_BUMP"),
    )

    def _bind_texture_slots(self, mat_id, params):
        for pname, slot_name in self._TEX_SLOTS:
            if pname in params and params[pname][0] == "texture":
                tid = self.textures.get(str(params[pname][1][0]))
                if tid is not None:
                    self.builder.set_material_texture(
                        mat_id, getattr(sa, slot_name), tid
                    )

    def _make_material(self, mtype, params):
        mid = self._make_material_raw(mtype, params)
        if mid is not None:
            self._bind_texture_slots(mid, params)
        return mid

    def _make_material_raw(self, mtype, params):
        b = self.builder
        if mtype in ("", "none"):
            return b.add_matte(kd=(0, 0, 0))
        if mtype == "matte":
            return b.add_matte(
                kd=self._texture_or_const(params, "Kd", (0.5, 0.5, 0.5)),
                sigma=ps.find_one(params, "sigma", 0.0),
            )
        if mtype == "plastic":
            return b.add_plastic(
                kd=self._texture_or_const(params, "Kd", (0.25,) * 3),
                ks=self._texture_or_const(params, "Ks", (0.25,) * 3),
                roughness=ps.find_one(params, "roughness", 0.1),
                remap=ps.find_one(params, "remaproughness", True),
            )
        if mtype == "mirror":
            return b.add_mirror(kr=self._texture_or_const(params, "Kr", (0.9,) * 3))
        if mtype == "glass":
            return b.add_glass(
                kr=self._texture_or_const(params, "Kr", (1,) * 3),
                kt=self._texture_or_const(params, "Kt", (1,) * 3),
                eta=ps.find_one(params, "eta", ps.find_one(params, "index", 1.5)),
                roughness=ps.find_one(params, "uroughness", ps.find_one(params, "roughness", 0.0)),
            )
        if mtype == "metal":
            cu_eta, cu_k = copper_rgb()
            return b.add_metal(
                eta3=ps.find_spectrum(params, "eta", cu_eta),
                k3=ps.find_spectrum(params, "k", cu_k),
                roughness=ps.find_one(params, "roughness", 0.01),
                remap=ps.find_one(params, "remaproughness", True),
            )
        if mtype == "substrate":
            return b.add_substrate(
                kd=self._texture_or_const(params, "Kd", (0.5,) * 3),
                ks=self._texture_or_const(params, "Ks", (0.5,) * 3),
                roughness=ps.find_one(params, "uroughness", ps.find_one(params, "roughness", 0.1)),
            )
        if mtype == "uber":
            return b.add_uber(
                kd=self._texture_or_const(params, "Kd", (0.25,) * 3),
                ks=self._texture_or_const(params, "Ks", (0.25,) * 3),
                kr=self._texture_or_const(params, "Kr", (0, 0, 0)),
                kt=self._texture_or_const(params, "Kt", (0, 0, 0)),
                roughness=ps.find_one(params, "roughness", 0.1),
                eta=ps.find_one(params, "eta", 1.5),
                opacity=self._texture_or_const(params, "opacity", (1, 1, 1)),
            )
        if mtype == "translucent":
            return b.add_translucent(kd=self._texture_or_const(params, "Kd", (0.25,) * 3))
        if mtype == "hair":
            return b.add_hair(
                sigma_a=ps.find_spectrum(params, "sigma_a", None),
                color=self._texture_or_const(params, "color", None),
                eumelanin=ps.find_one(params, "eumelanin", None),
                pheomelanin=ps.find_one(params, "pheomelanin", None),
                eta=ps.find_one(params, "eta", 1.55),
                beta_m=ps.find_one(params, "beta_m", 0.3),
                beta_n=ps.find_one(params, "beta_n", 0.3),
                alpha=ps.find_one(params, "alpha", 2.0),
            )
        if mtype == "disney":
            return b.add_disney(
                color=self._texture_or_const(params, "color", (0.5,) * 3),
                metallic=ps.find_one(params, "metallic", 0.0),
                roughness=ps.find_one(params, "roughness", 0.5),
                sheen=ps.find_one(params, "sheen", 0.0),
                clearcoat=ps.find_one(params, "clearcoat", 0.0),
                eta=ps.find_one(params, "eta", 1.5),
                spec_tint=ps.find_one(params, "speculartint", 0.0),
                anisotropic=ps.find_one(params, "anisotropic", 0.0),
                spec_trans=ps.find_one(params, "spectrans", 0.0),
                clearcoat_gloss=ps.find_one(params, "clearcoatgloss", 1.0),
                thin=bool(ps.find_one(params, "thin", False)),
                flatness=ps.find_one(params, "flatness", 0.0),
                diff_trans=ps.find_one(params, "difftrans", 1.0),
                sheen_tint=ps.find_one(params, "sheentint", 0.5),
            )
        if mtype == "subsurface":
            return b.add_subsurface(
                sigma_a=ps.find_spectrum(params, "sigma_a", None),
                sigma_s=ps.find_spectrum(params, "sigma_s", None),
                name=ps.find_string(params, "name", None),
                scale=ps.find_one(params, "scale", 1.0),
                eta=ps.find_one(params, "eta", 1.33),
                g=ps.find_one(params, "g", 0.0),
                kr=self._texture_or_const(params, "Kr", (1.0,) * 3),
                kt=self._texture_or_const(params, "Kt", (1.0,) * 3),
                roughness=ps.find_one(params, "uroughness", ps.find_one(params, "roughness", 0.0)),
            )
        if mtype == "fourier":
            bf = ps.find_string(params, "bsdffile", "")
            fp = Path(bf)
            if self.search_dir and not fp.is_absolute():
                fp = self.search_dir / fp
            try:
                return b.add_fourier(bsdffile=str(fp))
            except Exception as e:
                print(f"WARNING: fourier table {bf!r} load failed ({e})")
                return b.add_matte(kd=(0.5, 0.5, 0.5))
        if mtype == "mix":
            m1 = self.gs.named_materials.get(ps.find_string(params, "namedmaterial1"))
            m2 = self.gs.named_materials.get(ps.find_string(params, "namedmaterial2"))
            if m1 is not None and m2 is not None:
                return b.add_mix(
                    m1, m2, amount=ps.find_spectrum(params, "amount", (0.5,) * 3)
                )
        print(f"WARNING: material {mtype!r} approximated as matte")
        return b.add_matte(kd=self._texture_or_const(params, "Kd", (0.5, 0.5, 0.5)))

    def _st_material(self, st):
        self.gs.material_type = st.args[0]
        self.gs.material_params = st.params
        self.gs.material = self._make_material(st.args[0], st.params)

    def _st_makenamedmaterial(self, st):
        mtype = ps.find_string(st.params, "type", "matte")
        self.gs.named_materials[st.args[0]] = self._make_material(mtype, st.params)

    def _st_namedmaterial(self, st):
        if st.args[0] in self.gs.named_materials:
            self.gs.material = self.gs.named_materials[st.args[0]]
        else:
            print(f"WARNING: unknown named material {st.args[0]!r}")

    def _child_tex(self, params, name, default_rgb):
        """Resolve a texture-or-constant param to a texture id (creating an
        implicit constant texture for literal values — pbrt semantics)."""
        if name in params and params[name][0] == "texture":
            tid = self.textures.get(str(params[name][1][0]))
            if tid is not None:
                return tid
        val = ps.find_spectrum(params, name, default_rgb)
        return self.builder.add_texture(tx.TEX_CONSTANT, {tx.TP_VALUE: tuple(np.atleast_1d(val)[:3]) if hasattr(val, "__len__") else (val, val, val)})

    def _st_texture(self, st):
        """A texture-table entry per class (reference src/textures/* create
        functions through api.rs make_texture :1039)."""
        tex_name, _tex_kind, tex_class = st.args[0], st.args[1], st.args[2]
        p = st.params
        b = self.builder
        uvp = {
            tx.TP_SU: ps.find_one(p, "uscale", 1.0),
            tx.TP_SV: ps.find_one(p, "vscale", 1.0),
            tx.TP_DU: ps.find_one(p, "udelta", 0.0),
            tx.TP_DV: ps.find_one(p, "vdelta", 0.0),
        }
        w2t = tr.Transform(
            np.asarray(self.ctm, np.float32),
            np.linalg.inv(self.ctm.astype(np.float64)).astype(np.float32),
        )
        tid = None
        if tex_class == "constant":
            tid = b.add_texture(
                tx.TEX_CONSTANT, {tx.TP_VALUE: ps.find_spectrum(p, "value", (1, 1, 1))}
            )
        elif tex_class == "scale":
            c1 = self._child_tex(p, "tex1", (1, 1, 1))
            c2 = self._child_tex(p, "tex2", (1, 1, 1))
            tid = b.add_texture(tx.TEX_SCALE, {}, children=(c1, c2))
        elif tex_class == "mix":
            c1 = self._child_tex(p, "tex1", (0, 0, 0))
            c2 = self._child_tex(p, "tex2", (1, 1, 1))
            amt = ps.find_one(p, "amount", 0.5)
            tid = b.add_texture(
                tx.TEX_MIX, {tx.TP_VALUE: (amt, amt, amt)}, children=(c1, c2)
            )
        elif tex_class == "checkerboard":
            c1 = self._child_tex(p, "tex1", (1, 1, 1))
            c2 = self._child_tex(p, "tex2", (0, 0, 0))
            tid = b.add_texture(tx.TEX_CHECKER, uvp, children=(c1, c2))
        elif tex_class == "dots":
            c1 = self._child_tex(p, "inside", (1, 1, 1))
            c2 = self._child_tex(p, "outside", (0, 0, 0))
            tid = b.add_texture(tx.TEX_DOTS, uvp, children=(c1, c2))
        elif tex_class in ("fbm", "wrinkled"):
            kind = tx.TEX_FBM if tex_class == "fbm" else tx.TEX_WRINKLED
            tid = b.add_texture(
                kind,
                {tx.TP_VALUE: (1, 1, 1),
                 tx.TP_OCTAVES: ps.find_one(p, "octaves", 8),
                 tx.TP_OMEGA: ps.find_one(p, "roughness", 0.5)},
                world_to_texture=w2t,
            )
        elif tex_class == "marble":
            tid = b.add_texture(
                tx.TEX_MARBLE,
                {tx.TP_OCTAVES: ps.find_one(p, "octaves", 8),
                 tx.TP_OMEGA: ps.find_one(p, "roughness", 0.5),
                 tx.TP_SCALE_N: ps.find_one(p, "scale", 1.0),
                 tx.TP_VARIATION: ps.find_one(p, "variation", 0.2)},
                world_to_texture=w2t,
            )
        elif tex_class == "windy":
            tid = b.add_texture(tx.TEX_WINDY, {tx.TP_VALUE: (1, 1, 1)}, world_to_texture=w2t)
        elif tex_class == "uv":
            tid = b.add_texture(tx.TEX_UV, uvp)
        elif tex_class == "bilerp":
            v00 = ps.find_spectrum(p, "v00", (0, 0, 0))
            v11 = ps.find_spectrum(p, "v11", (1, 1, 1))
            c1 = b.add_texture(tx.TEX_CONSTANT, {tx.TP_VALUE: v00})
            c2 = b.add_texture(tx.TEX_CONSTANT, {tx.TP_VALUE: v11})
            tid = b.add_texture(tx.TEX_BILERP, uvp, children=(c1, c2))
        elif tex_class == "imagemap":
            fname = ps.find_string(p, "filename")
            try:
                fp = Path(fname)
                if self.search_dir and not fp.is_absolute():
                    fp = self.search_dir / fp
                img = np.asarray(read_image(fp), np.float32)
                wrap = {"repeat": 0, "clamp": 1, "black": 2}.get(
                    ps.find_string(p, "wrap", "repeat"), 0
                )
                prm = dict(uvp)
                prm[tx.TP_WRAP] = wrap
                prm[tx.TP_GAMMA_SCALE] = ps.find_one(p, "scale", 1.0)
                tid = b.add_texture(tx.TEX_IMAGEMAP, prm, image=img)
            except Exception as e:
                print(f"WARNING: imagemap {fname!r} load failed ({e}); using grey")
                tid = b.add_texture(tx.TEX_CONSTANT, {tx.TP_VALUE: (0.5, 0.5, 0.5)})
        else:
            print(f"WARNING: texture class {tex_class!r} -> constant grey")
            tid = b.add_texture(tx.TEX_CONSTANT, {tx.TP_VALUE: (0.5, 0.5, 0.5)})
        self.textures[tex_name] = tid

    # ---- lights ----

    def _light_map(self, params):
        """Load a light's "mapname" image, or None (reference
        lights/projection.rs + lights/gonio.rs constructors)."""
        fname = ps.find_string(params, "mapname")
        if not fname:
            return None
        try:
            p = Path(fname)
            if self.search_dir and not p.is_absolute():
                p = self.search_dir / p
            return read_image(p)
        except Exception as e:
            print(f"WARNING: light map {fname!r} load failed ({e})")
            return None

    def _st_lightsource(self, st):
        kind = st.args[0]
        b = self.builder
        scale = ps.find_spectrum(st.params, "scale", (1, 1, 1))
        if kind == "point":
            p = ps.find_floats(st.params, "from", [0, 0, 0])
            p_w = (self.ctm @ np.asarray([*p, 1.0], np.float32))[:3]
            b.add_point_light(p=p_w, I=ps.find_spectrum(st.params, "I", (1, 1, 1)), scale=scale)
        elif kind == "spot":
            p = ps.find_floats(st.params, "from", [0, 0, 0])
            to = ps.find_floats(st.params, "to", [0, 0, 1])
            p_w = (self.ctm @ np.asarray([*p, 1.0], np.float32))[:3]
            to_w = (self.ctm @ np.asarray([*to, 1.0], np.float32))[:3]
            b.add_spot_light(
                p=p_w, to=to_w, I=ps.find_spectrum(st.params, "I", (1, 1, 1)),
                cone_angle=ps.find_one(st.params, "coneangle", 30.0),
                cone_delta=ps.find_one(st.params, "conedeltaangle", 5.0),
                scale=scale,
            )
        elif kind == "distant":
            fr = ps.find_floats(st.params, "from", [0, 0, 0])
            to = ps.find_floats(st.params, "to", [0, 0, 1])
            fr_w = (self.ctm @ np.asarray([*fr, 1.0], np.float32))[:3]
            to_w = (self.ctm @ np.asarray([*to, 1.0], np.float32))[:3]
            b.add_distant_light(
                from_p=fr_w, to=to_w, L=ps.find_spectrum(st.params, "L", (1, 1, 1)), scale=scale
            )
        elif kind in ("projection", "goniometric"):
            img = self._light_map(st.params)
            p = ps.find_floats(st.params, "from", [0, 0, 0])
            to = ps.find_floats(st.params, "to", [0, 0, 1])
            p_w = (self.ctm @ np.asarray([*p, 1.0], np.float32))[:3]
            to_w = (self.ctm @ np.asarray([*to, 1.0], np.float32))[:3]
            I = ps.find_spectrum(st.params, "I", (1, 1, 1))
            if kind == "projection":
                b.add_projection_light(
                    p=p_w, to=to_w, I=I, scale=scale, image=img,
                    fov=ps.find_one(st.params, "fov", 45.0),
                )
            else:
                b.add_gonio_light(p=p_w, to=to_w, I=I, scale=scale, image=img)
        elif kind == "infinite":
            fname = ps.find_string(st.params, "mapname")
            rad = None
            if fname:
                try:
                    p = Path(fname)
                    if self.search_dir and not p.is_absolute():
                        p = self.search_dir / p
                    rad = read_image(p)
                except Exception as e:
                    print(f"WARNING: env map {fname!r} load failed ({e})")
            b.add_infinite_light(
                radiance_map=rad, L=ps.find_spectrum(st.params, "L", (1, 1, 1)),
                scale=scale,
                light_to_world=tr.from_matrix(self.ctm),
            )
        else:
            print(f"WARNING: light {kind!r} unsupported, skipped")

    def _st_arealightsource(self, st):
        self.gs.area_light = dict(
            L=ps.find_spectrum(st.params, "L", (1, 1, 1)),
            two_sided=ps.find_one(st.params, "twosided", False),
            scale=ps.find_spectrum(st.params, "scale", (1, 1, 1)),
        )

    # ---- shapes ----

    def _st_shape(self, st):
        if self.current_object is not None:
            self.objects[self.current_object].append((st, self.ctm.copy(), copy.deepcopy(self.gs)))
            return
        self._create_shape(st, self.ctm, self.gs, ctm_end=self.ctm_end)

    def _alpha_tex_id(self, params, name):
        """Resolve an alpha/shadowalpha parameter to a float-texture id
        (reference api.rs:1920-1940: a named texture, or a literal float 0
        which becomes a constant-0 texture; any other float means no mask)."""
        if name in params and params[name][0] == "texture":
            tid = self.textures.get(str(params[name][1][0]))
            if tid is None:
                print(f"WARNING: couldn't find float texture for {name!r}")
                return -1
            return tid
        if ps.find_one(params, name, 1.0) == 0.0:
            return self.builder.add_texture(tx.TEX_CONSTANT, {tx.TP_VALUE: (0.0, 0.0, 0.0)})
        return -1

    def _create_shape(self, st, ctm, gs, ctm_end=None):
        kind = st.args[0]
        b = self.builder
        o2w = tr.from_matrix(ctm)
        al = gs.area_light
        # object-level motion blur: a CTM pair differing between shutter
        # start and end (ActiveTransform statements) makes triangle meshes
        # animated (reference TransformedPrimitive + AnimatedTransform,
        # primitive.rs:198-265).  Restriction mirrored from instancing:
        # area-light / alpha-masked animated meshes fall back to the start
        # transform (warned).
        animated = (
            ctm_end is not None and not np.allclose(ctm, ctm_end, atol=1e-7)
        )
        if animated and kind in ("trianglemesh", "plymesh") and al is None:
            if kind == "trianglemesh":
                idx = np.asarray(ps.find_ints(st.params, "indices")).reshape(-1, 3)
                P = np.asarray(ps.find_floats(st.params, "P")).reshape(-1, 3)
                N0 = ps.find_floats(st.params, "N")
                uv0 = ps.find_floats(st.params, "uv") or ps.find_floats(st.params, "st")
                N0 = np.asarray(N0).reshape(-1, 3) if N0 else None
                uv0 = np.asarray(uv0).reshape(-1, 2) if uv0 else None
            else:
                fname = ps.find_string(st.params, "filename")
                p = Path(fname)
                if self.search_dir and not p.is_absolute():
                    p = self.search_dir / p
                P, idx, N0, uv0 = load_ply(p)
            b.add_animated_triangle_mesh(
                idx, P, tr.from_matrix(ctm), tr.from_matrix(ctm_end),
                normals=N0, uvs=uv0, material=gs.material,
                reverse_orientation=gs.reverse_orientation,
            )
            return
        if animated:
            print(
                "WARNING: animated transform on shape kind "
                f"{kind!r} (or with an area light) unsupported; "
                "using the shutter-open transform"
            )
        if kind == "trianglemesh":
            idx = ps.find_ints(st.params, "indices")
            P = ps.find_floats(st.params, "P")
            N = ps.find_floats(st.params, "N")
            uv = ps.find_floats(st.params, "uv") or ps.find_floats(st.params, "st")
            b.add_triangle_mesh(
                np.asarray(idx).reshape(-1, 3),
                np.asarray(P).reshape(-1, 3),
                normals=np.asarray(N).reshape(-1, 3) if N else None,
                uvs=np.asarray(uv).reshape(-1, 2) if uv else None,
                material=gs.material,
                object_to_world=o2w,
                area_light=al,
                reverse_orientation=gs.reverse_orientation,
                medium_interface=gs.medium_interface,
                alpha_tex=self._alpha_tex_id(st.params, "alpha"),
                shadow_alpha_tex=self._alpha_tex_id(st.params, "shadowalpha"),
            )
        elif kind == "plymesh":
            fname = ps.find_string(st.params, "filename")
            p = Path(fname)
            if self.search_dir and not p.is_absolute():
                p = self.search_dir / p
            V, F, N, UV = load_ply(p)
            b.add_triangle_mesh(
                F, V, normals=N, uvs=UV, material=gs.material,
                object_to_world=o2w, area_light=al,
                reverse_orientation=gs.reverse_orientation,
                medium_interface=gs.medium_interface,
                alpha_tex=self._alpha_tex_id(st.params, "alpha"),
                shadow_alpha_tex=self._alpha_tex_id(st.params, "shadowalpha"),
            )
        elif kind == "sphere":
            b.add_sphere(
                o2w,
                radius=ps.find_one(st.params, "radius", 1.0),
                z_min=ps.find_one(st.params, "zmin", None),
                z_max=ps.find_one(st.params, "zmax", None),
                phi_max=ps.find_one(st.params, "phimax", 360.0),
                material=gs.material,
                area_light=al,
                reverse_orientation=gs.reverse_orientation,
                medium_interface=gs.medium_interface,
            )
        elif kind == "cylinder":
            # analytic quadric (reference shapes/cylinder.rs), with or
            # without an attached area light (cylinder.rs sample)
            b.add_cylinder(
                object_to_world=o2w,
                radius=ps.find_one(st.params, "radius", 1.0),
                z_min=ps.find_one(st.params, "zmin", -1.0),
                z_max=ps.find_one(st.params, "zmax", 1.0),
                phi_max=ps.find_one(st.params, "phimax", 360.0),
                material=gs.material,
                area_light=al,
                reverse_orientation=gs.reverse_orientation,
                medium_interface=gs.medium_interface,
            )
        elif kind == "disk":
            b.add_disk(
                object_to_world=o2w,
                height=ps.find_one(st.params, "height", 0.0),
                radius=ps.find_one(st.params, "radius", 1.0),
                inner_radius=ps.find_one(st.params, "innerradius", 0.0),
                phi_max=ps.find_one(st.params, "phimax", 360.0),
                material=gs.material,
                area_light=al,
                reverse_orientation=gs.reverse_orientation,
                medium_interface=gs.medium_interface,
            )
        elif kind in ("paraboloid", "cone", "hyperboloid"):
            tris = _tessellate_quadric(kind, st.params)
            if tris is not None:
                V, F = tris
                b.add_triangle_mesh(
                    F, V, material=gs.material, object_to_world=o2w,
                    area_light=al, reverse_orientation=gs.reverse_orientation,
                    medium_interface=gs.medium_interface,
                )
        elif kind == "loopsubdiv":
            idx = np.asarray(ps.find_ints(st.params, "indices")).reshape(-1, 3)
            P = np.asarray(ps.find_floats(st.params, "P")).reshape(-1, 3)
            levels = ps.find_one(st.params, "levels", ps.find_one(st.params, "nlevels", 3))
            V, F, N = loop_subdivide(P, idx, int(levels))
            b.add_triangle_mesh(
                F, V, normals=N, material=gs.material, object_to_world=o2w,
                area_light=al, reverse_orientation=gs.reverse_orientation,
            )
        elif kind == "nurbs":
            nu = int(ps.find_one(st.params, "nu", 0))
            nv = int(ps.find_one(st.params, "nv", 0))
            uo = int(ps.find_one(st.params, "uorder", 0))
            vo = int(ps.find_one(st.params, "vorder", 0))
            uk = ps.find_floats(st.params, "uknots")
            vk = ps.find_floats(st.params, "vknots")
            Pn = ps.find_floats(st.params, "P")
            Pw = ps.find_floats(st.params, "Pw")
            if Pw:
                pw = np.asarray(Pw, np.float32).reshape(-1, 4)
                P = pw[:, :3] / np.maximum(pw[:, 3:4], 1e-12)
                wgt = pw[:, 3]
            else:
                P = np.asarray(Pn, np.float32).reshape(-1, 3)
                wgt = None
            V, F, UV = tessellate_nurbs(uo, uk, nu, vo, vk, nv, P, wgt)
            b.add_triangle_mesh(
                F, V, uvs=UV, material=gs.material, object_to_world=o2w,
                area_light=al, reverse_orientation=gs.reverse_orientation,
            )
        elif kind == "heightfield":
            # nu x nv z-grid over [0,1]^2 -> triangle mesh (reference
            # api.rs:2016 heightfield stub; pbrt-v3 heightfield.cpp semantics)
            nu = int(ps.find_one(st.params, "nu", 0))
            nv = int(ps.find_one(st.params, "nv", 0))
            Pz = ps.find_floats(st.params, "Pz")
            if nu < 2 or nv < 2 or len(Pz) != nu * nv:
                print("WARNING: heightfield with bad nu/nv/Pz, skipped")
                return
            z = np.asarray(Pz, np.float32).reshape(nv, nu)
            xs = np.linspace(0.0, 1.0, nu, dtype=np.float32)
            ys = np.linspace(0.0, 1.0, nv, dtype=np.float32)
            X, Y = np.meshgrid(xs, ys)
            V = np.stack([X.ravel(), Y.ravel(), z.ravel()], -1)
            UVg = np.stack([X.ravel(), Y.ravel()], -1)
            F = []
            for j in range(nv - 1):
                for i in range(nu - 1):
                    a = j * nu + i
                    F += [[a, a + 1, a + nu], [a + 1, a + nu + 1, a + nu]]
            b.add_triangle_mesh(
                np.asarray(F, np.int32), V, uvs=UVg, material=gs.material,
                object_to_world=o2w, area_light=al,
                reverse_orientation=gs.reverse_orientation,
                medium_interface=gs.medium_interface,
            )
        elif kind == "curve":
            P = np.asarray(ps.find_floats(st.params, "P"), np.float32).reshape(-1, 3)
            nrm = ps.find_floats(st.params, "N")
            width = ps.find_one(st.params, "width", 1.0)
            # multi-segment Bézier: 4 + 3*(n-1) control points -> n segments
            # (reference shapes/curve.rs create_curve_shape :556)
            n_seg = max(1, (len(P) - 1) // 3)
            cps = np.stack([P[3 * i: 3 * i + 4] for i in range(n_seg)])
            b.add_curve(
                cps,
                width0=ps.find_one(st.params, "width0", width),
                width1=ps.find_one(st.params, "width1", width),
                curve_type=ps.find_string(st.params, "type", "flat"),
                normals=(
                    np.stack(
                        [
                            np.asarray(nrm, np.float32).reshape(-1, 3)[[i, i + 1]]
                            for i in range(n_seg)
                        ]
                    )
                    if nrm
                    else None
                ),
                splitdepth=int(ps.find_one(st.params, "splitdepth", 3)),
                material=gs.material,
                object_to_world=o2w,
            )
        else:
            print(f"WARNING: shape {kind!r} unsupported, skipped")

    # ---- instancing (reference api.rs:3001-3050) ----

    def _st_objectbegin(self, st):
        self.objects[st.args[0]] = []
        self.current_object = st.args[0]
        self._st_attributebegin(st)

    def _st_objectend(self, st):
        self._st_attributeend(st)
        self.current_object = None

    # Flattening duplicates geometry per instance (O(uses x tris) memory);
    # objects whose flattened footprint exceeds this use the two-level BVH
    # (ops/instancing.py, reference primitive.rs:198-265).  Small objects
    # keep flattening — cheaper than a second traversal level.
    FLATTEN_INSTANCE_LIMIT = 50_000

    def _st_objectinstance(self, st):
        # deferred: _resolve_instances (at finish) decides flatten vs
        # two-level instancing once the total use count is known
        self.instance_uses.append((st.args[0], self.ctm.copy()))

    def _realize_object_tris(self, name):
        """Replays an object's shapes into a scratch triangle table (object
        space).  Returns its (T, N_TRI_ATTR) rows, or None if the object
        holds other shapes or area lights (those flatten)."""
        shapes = self.objects.get(name, [])
        b = self.builder
        saved_blocks = b.tri_blocks
        saved_rows = b.n_tri_rows
        n_sph0, n_crv0 = len(b.sph_rows), len(b.curves)
        n_lights0 = len(b.lights)
        b.tri_blocks = []
        b.n_tri_rows = 0
        try:
            for shape_st, shape_ctm, shape_gs in shapes:
                self._create_shape(shape_st, shape_ctm, shape_gs)
            ok = (
                len(b.sph_rows) == n_sph0
                and len(b.curves) == n_crv0
                and len(b.lights) == n_lights0
                and b.n_tri_rows > 0
            )
            if not ok:
                # roll back any quadric/curve/light side effects and flatten
                del b.sph_rows[n_sph0:]
                del b.curves[n_crv0:]
                del b.lights[n_lights0:]
                return None
            return np.concatenate(b.tri_blocks)
        finally:
            b.tri_blocks = saved_blocks
            b.n_tri_rows = saved_rows

    def _resolve_instances(self):
        if not self.instance_uses:
            return
        from collections import Counter

        counts = Counter(n for n, _ in self.instance_uses)
        proto_ids = {}
        for name, cnt in counts.items():
            shapes = self.objects.get(name, [])
            if not shapes:
                continue
            realized = self._realize_object_tris(name)
            if realized is None:
                continue
            if len(realized) * cnt > self.FLATTEN_INSTANCE_LIMIT:
                proto_ids[name] = self.builder.add_prototype_tris(_rows_to_tris(realized))
        for name, ctm in self.instance_uses:
            if name in proto_ids:
                self.builder.add_instance(
                    proto_ids[name], tr.from_matrix(ctm)
                )
            else:
                for shape_st, shape_ctm, shape_gs in self.objects.get(name, []):
                    self._create_shape(shape_st, ctm @ shape_ctm, shape_gs)

    def _st_makenamedmedium(self, st):
        """MakeNamedMedium (reference api.rs pbrt_make_named_medium +
        make_medium :953): homogeneous or heterogeneous density-grid."""
        name = st.args[0]
        mtype = ps.find_string(st.params, "type", "homogeneous")
        g = ps.find_one(st.params, "g", 0.0)
        scale = ps.find_one(st.params, "scale", 1.0)
        sigma_a = ps.find_spectrum(st.params, "sigma_a", (0.0011, 0.0024, 0.014))
        sigma_s = ps.find_spectrum(st.params, "sigma_s", (2.55, 3.21, 3.77))
        preset = ps.find_string(st.params, "preset", "")
        if preset:
            props = get_medium_scattering_properties(preset)
            if props is None:
                print(f"WARNING: material {preset!r} not recognized")
            else:
                sigma_a, sigma_s = props
        grid = None
        m2w = None
        if mtype == "heterogeneous":
            dens = ps.find_floats(st.params, "density")
            nx = int(ps.find_one(st.params, "nx", 1))
            ny = int(ps.find_one(st.params, "ny", 1))
            nz = int(ps.find_one(st.params, "nz", 1))
            if not dens or len(dens) != nx * ny * nz:
                print("WARNING: heterogeneous medium with bad density grid")
                dens = [1.0] * (nx * ny * nz)
            p0 = np.asarray(ps.find_floats(st.params, "p0", [0, 0, 0]), np.float64)
            p1 = np.asarray(ps.find_floats(st.params, "p1", [1, 1, 1]), np.float64)
            # density index order is (z*ny + y)*nx + x -> (D,H,W)
            grid = np.asarray(dens, np.float32).reshape(nz, ny, nx)
            unit_to_grid = np.eye(4, dtype=np.float64)
            unit_to_grid[:3, :3] = np.diag(p1 - p0)
            unit_to_grid[:3, 3] = p0
            m2w = tr.from_matrix(
                (self.ctm.astype(np.float64) @ unit_to_grid).astype(np.float32)
            )
        mid = self.builder.add_medium(
            sigma_a, sigma_s, g=g, scale=scale, density_grid=grid,
            medium_to_world=m2w,
        )
        self.named_media[name] = mid

    def _st_mediuminterface(self, st):
        """MediumInterface "inside" "outside" ("" = vacuum)."""
        inside = st.args[0] if len(st.args) > 0 else ""
        outside = st.args[1] if len(st.args) > 1 else ""

        def _resolve(nm):
            if not nm:
                return -1
            mid = self.named_media.get(nm)
            if mid is None:
                print(f"WARNING: named medium {nm!r} undefined")
                return -1
            return mid

        self.gs.medium_interface = (_resolve(inside), _resolve(outside))

    def _st_include(self, st):
        pass  # handled by the parser

    # ---- final assembly (reference make_integrator/make_scene) ----

    def finish(self, overrides=None, device="cuda"):
        """(scene, camera, RenderCfg, SamplerCfg, FilterCfg, output name),
        the scene and camera on device.  overrides: "integrator" and
        "samples" in place of the file's (main's -i and -s)."""
        overrides = overrides or {}
        xres = int(ps.find_one(self.film_params, "xresolution", 1280))
        yres = int(ps.find_one(self.film_params, "yresolution", 720))
        resolution = (xres, yres)

        spp = int(overrides.get("samples") or ps.find_one(self.sampler_params, "pixelsamples", 16))
        sampler_kinds = {
            "sobol": smpl.SOBOL, "random": smpl.RANDOM,
            "lowdiscrepancy": smpl.ZEROTWO, "02sequence": smpl.ZEROTWO,
            "stratified": smpl.STRATIFIED, "halton": smpl.HALTON,
            "maxmindist": smpl.MAXMIN,
        }
        sampler_cfg = smpl.make_sampler(
            sampler_kinds.get(self.sampler_name, smpl.SOBOL), spp, resolution
        )

        integrator = overrides.get("integrator") or self.integrator_name
        ip = self.integrator_params
        max_depth = int(ps.find_one(ip, "maxdepth", 5))
        rr_threshold = float(ps.find_one(ip, "rrthreshold", 1.0))
        light_strategy = {
            "uniform": "uniform", "power": "power", "spatial": "spatial",
        }.get(ps.find_string(ip, "lightsamplestrategy", "spatial"), "spatial")
        # scene-file crop window (reference film.rs:185,224-262); CLI crop
        # overrides it in main
        cw = ps.find_floats(self.film_params, "cropwindow", None)
        crop = tuple(cw) if cw and len(cw) == 4 and tuple(cw) != (0, 1, 0, 1) else None
        # integrator-specific factory params (reference api.rs :205-473)
        extra = {}
        if integrator == "bdpt":
            extra["visualize_strategies"] = bool(ps.find_one(ip, "visualizestrategies", False))
        elif integrator == "mlt":
            extra.update(
                bootstrap_samples=int(ps.find_one(ip, "bootstrapsamples", 100000)),
                chains=int(ps.find_one(ip, "chains", 1000)),
                mutations_per_pixel=int(ps.find_one(ip, "mutationsperpixel", 100)),
                sigma=float(ps.find_one(ip, "sigma", 0.01)),
                large_step_probability=float(ps.find_one(ip, "largestepprobability", 0.3)),
            )
        elif integrator == "sppm":
            extra.update(
                n_iterations=int(ps.find_one(ip, "numiterations",
                                             ps.find_one(ip, "iterations", 64))),
                photons_per_iteration=int(ps.find_one(ip, "photonsperiteration", -1)),
                initial_radius=float(ps.find_one(ip, "radius", 1.0)),
                max_depth=int(ps.find_one(ip, "maxdepth", 5)),
            )
        elif integrator == "ao":
            extra.update(
                n_samples=int(ps.find_one(ip, "nsamples", 64)),
                cos_sample=bool(ps.find_one(ip, "cossample", True)),
            )
        elif integrator == "directlighting":
            extra["strategy"] = ps.find_string(ip, "strategy", "all")
        cfg = rdr.RenderCfg(
            integrator, sampler_cfg.spp, max_depth, rr_threshold,
            light_strategy=light_strategy, crop=crop, extra=extra,
            accelerator=self.accelerator_name,
        )

        filter_kinds = {
            "box": filmmod.FILTER_BOX, "triangle": filmmod.FILTER_TRIANGLE,
            "gaussian": filmmod.FILTER_GAUSSIAN, "mitchell": filmmod.FILTER_MITCHELL,
            "sinc": filmmod.FILTER_SINC,
        }
        fk = filter_kinds.get(self.filter_name, filmmod.FILTER_BOX)
        filter_cfg = filmmod.make_filter(
            fk,
            xwidth=ps.find_one(self.filter_params, "xwidth", None),
            ywidth=ps.find_one(self.filter_params, "ywidth", None),
        )

        fov = float(ps.find_one(self.camera_params, "fov", 90.0))
        c2w = tr.from_matrix(self.camera_to_world)
        sh_open = float(ps.find_one(self.camera_params, "shutteropen", 0.0))
        sh_close = float(ps.find_one(self.camera_params, "shutterclose", 1.0))
        sh = dict(shutter_open=sh_open, shutter_close=sh_close)
        c2w_end = None
        if not np.allclose(self.camera_to_world, self.camera_to_world_end):
            c2w_end = tr.from_matrix(self.camera_to_world_end)
        if self.camera_name == "orthographic":
            camera = cam.make_orthographic(c2w, resolution, device=device, **sh)
        elif self.camera_name == "environment":
            camera = cam.make_environment(c2w, resolution, device=device)
        elif self.camera_name == "realistic":
            lens_file = ps.find_string(self.camera_params, "lensfile", "")
            lf = Path(lens_file)
            if self.search_dir and not lf.is_absolute():
                lf = self.search_dir / lf
            lens_data = read_float_file(lf)
            camera = cam.make_realistic(
                c2w, resolution, lens_data,
                aperture_diameter=ps.find_one(self.camera_params, "aperturediameter", 1.0),
                focus_distance=ps.find_one(self.camera_params, "focusdistance", 10.0),
                film_diag_mm=ps.find_one(self.film_params, "diagonal", 35.0),
                simple_weighting=ps.find_one(self.camera_params, "simpleweighting", True),
                device=device,
            )
        else:
            camera = cam.make_perspective(
                c2w, resolution, fov=fov,
                lens_radius=ps.find_one(self.camera_params, "lensradius", 0.0),
                focal_distance=ps.find_one(self.camera_params, "focaldistance", 1e6),
                cam_to_world_end=c2w_end, device=device, **sh,
            )

        scene = self.builder.finalize(device)
        return scene, camera, cfg, sampler_cfg, filter_cfg, self.output_name


def load_pbrt(path, overrides=None, device="cuda"):
    """Parses and runs a .pbrt file (reference main() rs_pbrt.rs:890):
    (scene, camera, RenderCfg, SamplerCfg, FilterCfg, output name), the
    scene and camera on device."""
    path = Path(path)
    api = PbrtAPI(search_dir=path.parent)
    for st in ps.parse_file(path):
        api.do_statement(st)
    return api.finish(overrides, device=device)


def _rows_to_tris(rows):
    """SceneBuilder.add_prototype_tris' per-triangle lists of the triangle
    rows (T, N_TRI_ATTR) of an object."""
    col = lambda c, w: [rows[:, c:c + w]]
    one = lambda c: [rows[:, c]]
    return dict(p0=col(sa.TA_P0, 3), p1=col(sa.TA_P1, 3), p2=col(sa.TA_P2, 3),
                n0=col(sa.TA_N0, 3), n1=col(sa.TA_N1, 3), n2=col(sa.TA_N2, 3),
                uv0=col(sa.TA_UV0, 2), uv1=col(sa.TA_UV1, 2), uv2=col(sa.TA_UV2, 2),
                has_n=one(sa.TA_HAS_N), mat=one(sa.TA_MAT), reverse=one(sa.TA_REVERSE))


def _tessellate_quadric(kind, params):
    """(V, F) of a disk, cylinder, cone, paraboloid or hyperboloid
    tessellated into triangles in object space, or None for another kind.
    The API takes cones, paraboloids and hyperboloids through it; disks
    and cylinders are analytic quadrics there."""
    n_u = 64
    if kind == "disk":
        h = ps.find_one(params, "height", 0.0)
        r = ps.find_one(params, "radius", 1.0)
        ir = ps.find_one(params, "innerradius", 0.0)
        phi_max = np.deg2rad(ps.find_one(params, "phimax", 360.0))
        phis = np.linspace(0, phi_max, n_u + 1)
        outer = np.stack([r * np.cos(phis), r * np.sin(phis), np.full_like(phis, h)], -1)
        if ir > 0:
            inner = np.stack(
                [ir * np.cos(phis), ir * np.sin(phis), np.full_like(phis, h)], -1
            )
            V = np.concatenate([outer, inner]).astype(np.float32)
            F = []
            for i in range(n_u):
                a, b_, c, d = i, i + 1, n_u + 1 + i, n_u + 1 + i + 1
                F += [[a, c, b_], [b_, c, d]]
            return V, np.asarray(F, np.int32)
        center = np.asarray([[0.0, 0.0, h]], np.float32)
        V = np.concatenate([center, outer]).astype(np.float32)
        F = [[0, 1 + i, 1 + i + 1] for i in range(n_u)]
        return V, np.asarray(F, np.int32)
    if kind == "cylinder":
        r = ps.find_one(params, "radius", 1.0)
        z0 = ps.find_one(params, "zmin", -1.0)
        z1 = ps.find_one(params, "zmax", 1.0)
        phi_max = np.deg2rad(ps.find_one(params, "phimax", 360.0))
        phis = np.linspace(0, phi_max, n_u + 1)
        lo = np.stack([r * np.cos(phis), r * np.sin(phis), np.full_like(phis, z0)], -1)
        hi = np.stack([r * np.cos(phis), r * np.sin(phis), np.full_like(phis, z1)], -1)
        V = np.concatenate([lo, hi]).astype(np.float32)
        F = []
        for i in range(n_u):
            a, b_, c, d = i, i + 1, n_u + 1 + i, n_u + 1 + i + 1
            F += [[a, b_, c], [b_, d, c]]
        return V, np.asarray(F, np.int32)
    if kind in ("cone", "paraboloid", "hyperboloid"):
        r = ps.find_one(params, "radius", 1.0)
        h = ps.find_one(params, "height", 1.0)
        n_v = 16
        phis = np.linspace(0, 2 * np.pi, n_u + 1)
        vs = np.linspace(0, 1, n_v + 1)
        Vs = []
        for v in vs:
            if kind == "cone":
                rr, zz = r * (1 - v), h * v
            elif kind == "paraboloid":
                rr, zz = r * np.sqrt(v), h * v
            else:
                rr, zz = r * (1 + v), h * v
            Vs.append(np.stack([rr * np.cos(phis), rr * np.sin(phis), np.full_like(phis, zz)], -1))
        V = np.concatenate(Vs).astype(np.float32)
        F = []
        W = n_u + 1
        for j in range(n_v):
            for i in range(n_u):
                a, b_, c, d = j * W + i, j * W + i + 1, (j + 1) * W + i, (j + 1) * W + i + 1
                F += [[a, b_, c], [b_, d, c]]
        return V, np.asarray(F, np.int32)
    return None
