"""Shared set-up of the port's tests on BASELINE config 5's scenes
(assets/scenes/caustic_only.pbrt and caustic_hair.pbrt): the scene text
with its settings replaced, the JAX front end's parse of it bridged into
the port, the port's render on the CPU, and the JAX package's renders of a
batch of such texts in one subprocess whose XLA contracts no FMAs
(XLA_FLAGS=--xla_cpu_max_isa=SSE4_2, as tests/test_torch_bvh.py runs it).

Why a subprocess: in this process XLA's CPU compiler contracts products
and sums into fused multiply-adds, which the port does not.  Where a path
holds a throughput of exactly 1 (a chain of specular bounces whose f
cos / pdf is 1), the rounding decides Russian roulette's test beta < 1,
and one lane in a thousand then takes the other branch: its estimate
differs by the survivor's factor 1 / (1 - q).  Without the contraction
the two packages round alike.  For the same reason ``path_lanes`` gives
the path integrator's per-lane radiance as the JAX package computes it op
by op (its render_batch's jit rounds the camera rays otherwise, and on the
caustic scene at 32x32, 4 spp its render differs from its own per-lane
radiance in one pixel by that factor).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

from rs_pbrt_tpu.scene.api import load_pbrt
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import film as filmmod
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from test_torch_scene import bridge

ROOT = Path(__file__).resolve().parent.parent
SCENES = ROOT / "assets" / "scenes"


def scene_text(name: str, res: int, integrator: str = None, sampler: str = None,
               spp: int = None, iterations: int = None, depth: int = None) -> str:
    """assets/scenes/<name>.pbrt at res x res, its Integrator and Sampler
    lines replaced where asked."""
    txt = (SCENES / f"{name}.pbrt").read_text()
    txt = re.sub(r'"integer xresolution" \d+', f'"integer xresolution" {res}', txt)
    txt = re.sub(r'"integer yresolution" \d+', f'"integer yresolution" {res}', txt)
    integ = re.search(r'^Integrator .*$', txt, re.M).group(0)
    samp = re.search(r'^Sampler .*$', txt, re.M).group(0)
    kind = integrator or re.search(r'Integrator "(\w+)"', integ).group(1)
    depth = depth or int(re.search(r'"integer maxdepth" (\d+)', integ).group(1))
    new_integ = f'Integrator "{kind}" "integer maxdepth" {depth}'
    if kind == "sppm":
        its = iterations or int(re.search(r'"integer numiterations" (\d+)', integ).group(1))
        new_integ = f'Integrator "sppm" "integer numiterations" {its} "integer maxdepth" {depth}'
    sampler = sampler or re.search(r'Sampler "(\w+)"', samp).group(1)
    new_samp = f'Sampler "{sampler}" "integer pixelsamples" {spp or 1}'
    return txt.replace(integ, new_integ).replace(samp, new_samp)


def parse(text: str, tmp_path: Path, tag: str):
    """The JAX front end's (scene, camera, cfg, sampler cfg, filter cfg)."""
    path = tmp_path / f"{tag}.pbrt"
    path.write_text(text)
    return load_pbrt(str(path), {})[:5]


def port_inputs(jscene, jcamera, jcfg, jscfg, jfcfg):
    """The parse bridged into the port, on the CPU: (scene, camera, cfg,
    sampler cfg, filter cfg)."""
    scene = bridge(jscene)
    camera = cam.camera_from_numpy({f.name: getattr(jcamera, f.name)
                                    for f in dataclasses.fields(jcamera)}, device="cpu")
    cfg = rdr.RenderCfg(jcfg.integrator, jcfg.spp, jcfg.max_depth, jcfg.rr_threshold,
                        light_strategy=jcfg.light_strategy, crop=jcfg.crop, extra=jcfg.extra)
    scfg = smpl.make_sampler(jscfg.kind, jscfg.spp, camera.resolution, jscfg.seed)
    return scene, camera, cfg, scfg, filmmod.FilterCfg(jfcfg.kind, jfcfg.xwidth, jfcfg.ywidth)


def port_render(text: str, tmp_path: Path, tag: str, stats: dict = None, crop=None):
    """The port's CPU render of the scene text, as float64."""
    scene, camera, cfg, scfg, fcfg = port_inputs(*parse(text, tmp_path, tag))
    return rdr.render(scene, camera, cfg, scfg, fcfg, accel=si.build_accel(scene, device="cpu"),
                      stats=stats, crop=crop).numpy().astype(np.float64)


_JAX_NO_FMA = r"""
import json, sys
import numpy as np
from rs_pbrt_tpu.models.integrators import render as rdr
from rs_pbrt_tpu.ops.scene_intersect import build_accel
from rs_pbrt_tpu.scene.api import load_pbrt
jobs = json.load(open(sys.argv[1]))
out = {}
for tag, (path, crop) in jobs.items():
    scene, camera, cfg, scfg, fcfg, _ = load_pbrt(path, {})
    if tag.startswith("lanes"):
        import jax.numpy as jnp
        from rs_pbrt_tpu.models import lightdistrib, samplers
        from rs_pbrt_tpu.models.integrators import path as jpath
        (w, h), spp = camera.resolution, scfg.spp
        xs, ys = np.meshgrid(np.arange(w), np.arange(h))
        pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1))
        ctx = samplers.make_ctx(scfg, jnp.asarray(pix, jnp.int32),
                                jnp.asarray(np.repeat(np.arange(spp), w * h), jnp.uint32),
                                frame_lt_spp=True)
        rays, _, _ = rdr._camera_rays(camera, scfg, ctx, ctx.pixel)
        dist = (lightdistrib.build_spatial(scene) if cfg.light_strategy == "spatial"
                else None)
        L = jpath.radiance(scene, jpath.PathCfg(cfg.max_depth, cfg.rr_threshold), scfg, ctx,
                           rays.o, rays.d, None, light_distrib=dist, regen=False)
        out[tag] = np.asarray(L, np.float64)
        out[tag + ":o"], out[tag + ":d"] = np.asarray(rays.o), np.asarray(rays.d)
        continue
    st = {}
    img = rdr.render(scene, camera, cfg, scfg, fcfg, accel=build_accel(scene, kind="bvh"),
                     stats=st, crop=tuple(crop) if crop else None)
    out[tag] = np.asarray(img, np.float64)
    for k in ("grid_bucket_overflow", "grid_res_last"):
        if k in st:
            out[f"{tag}:{k}"] = np.asarray(st[k])
np.savez(sys.argv[2], **out)
"""


def jax_renders(jobs: dict, tmp_path: Path) -> dict:
    """{tag: (scene text, crop or None)} -> {tag: the JAX package's render
    (H, W, 3) float64, and for sppm "tag:grid_bucket_overflow" and
    "tag:grid_res_last"}, rendered in one subprocess without FMA
    contraction.  A tag that starts with "lanes" gives instead the path
    integrator's radiance (N, 3) on the render's camera rays, lane n the
    pixel n mod (w h), sample n div (w h), computed op by op, and the rays
    as "tag:o" and "tag:d"."""
    spec = {}
    for tag, (text, crop) in jobs.items():
        path = tmp_path / f"jax_{tag}.pbrt"
        path.write_text(text)
        spec[tag] = (str(path), list(crop) if crop else None)
    (tmp_path / "jobs.json").write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", _JAX_NO_FMA, str(tmp_path / "jobs.json"),
                    str(tmp_path / "out.npz")], env=env, check=True, timeout=900, cwd=ROOT)
    return dict(np.load(tmp_path / "out.npz"))
