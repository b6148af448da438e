"""Shared set-up of the port's tests on the material grid
(rs_pbrt_tpu_torch/tools/material_scenes.py): the scene at a small size
through either package's builder, and the JAX package's per-lane radiance
of each integrator and its SPPM render, computed in one subprocess whose
XLA contracts no FMAs (XLA_FLAGS=--xla_cpu_max_isa=SSE4_2), as
tests/_envscene.py computes them.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

RES, SPP, DEPTH = 16, 4, 5
DIRECT_DEPTH = 2  # whitted and directlighting unroll their depth (the JAX loops)
SKY_HW = (32, 64)  # the tests' sky map
N_MU = 12  # the glossy Fourier table's nodes
SPPM_ITERATIONS = 1
SPPM_DEPTH = 1

# tag -> (integrator, options); the per-lane jobs of the JAX subprocess
LANE_JOBS = {
    "path": ("path", {}),
    "volpath": ("volpath", {}),
    "whitted": ("whitted", {}),
    "dl_all": ("directlighting", {"sample_all": True}),
}


def fourier_table():
    from rs_pbrt_tpu_torch.ops import fourier_bsdf as fb
    from rs_pbrt_tpu_torch.tools import material_scenes as ms

    return fb.make_fourier_table(ms.glossy_fourier_table(N_MU))


def port_scene(ground_cells: int = 1):
    """material_grid at RES on the CPU through the port's builder: (scene,
    camera)."""
    from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
    from rs_pbrt_tpu_torch.tools import env_scenes
    from rs_pbrt_tpu_torch.tools import material_scenes as ms

    b = ms.build(SceneBuilder(), env_scenes.sky_map(*SKY_HW), fourier_table(), ground_cells)
    return b.finalize("cpu"), ms.camera((RES, RES), "cpu")


_JAX_LANES = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
import _matscene as E
from rs_pbrt_tpu.models import cameras, samplers
from rs_pbrt_tpu.models.integrators import direct as jdirect
from rs_pbrt_tpu.models.integrators import path as jpath
from rs_pbrt_tpu.models.integrators import render as rdr
from rs_pbrt_tpu.models.integrators import volpath as jvol
from rs_pbrt_tpu.scene.builder import SceneBuilder
from rs_pbrt_tpu.utils import transform as tr
from rs_pbrt_tpu_torch.tools import env_scenes
from rs_pbrt_tpu_torch.tools import material_scenes as ms
jobs = json.load(open(sys.argv[1]))
scene = ms.build(SceneBuilder(), env_scenes.sky_map(*E.SKY_HW), E.fourier_table()).finalize()
res, spp, depth = E.RES, E.SPP, E.DEPTH
camera = cameras.make_perspective(tr.look_at(*ms.CAMERA[:3]), (res, res), fov=ms.CAMERA[3])
scfg = samplers.make_sampler(samplers.SOBOL, spp, (res, res))
xs, ys = np.meshgrid(np.arange(res), np.arange(res))
pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1))
ctx = samplers.make_ctx(scfg, jnp.asarray(pix, jnp.int32),
                        jnp.asarray(np.repeat(np.arange(spp), res * res), jnp.uint32),
                        frame_lt_spp=True)
rays, _, _ = rdr._camera_rays(camera, scfg, ctx, ctx.pixel)
o, d = rays.o, rays.d
out = {"o": np.asarray(o), "d": np.asarray(d)}
for tag in jobs:
    if tag == "sppm":
        cfg = rdr.RenderCfg("sppm", 1, E.SPPM_DEPTH, 1.0,
                            extra=dict(n_iterations=E.SPPM_ITERATIONS))
        img = rdr.render(scene, camera, cfg, samplers.make_sampler(samplers.SOBOL, 1, (res, res)))
        out[tag] = np.asarray(img, np.float64)
        continue
    integrator, opt = E.LANE_JOBS[tag]
    pcfg = jpath.PathCfg(depth, 1.0)
    if integrator == "path":
        L = jpath.radiance(scene, pcfg, scfg, ctx, o, d, None, regen=False)
    elif integrator == "volpath":
        L = jvol.radiance(scene, pcfg, scfg, ctx, o, d, None)
    elif integrator == "whitted":
        L = jdirect.whitted_radiance(scene, jdirect.WhittedCfg(E.DIRECT_DEPTH), scfg, ctx, o, d)
    else:
        L = jdirect.directlighting_radiance(
            scene, jdirect.DirectLightingCfg(E.DIRECT_DEPTH, opt["sample_all"]), scfg, ctx, o, d)
    out[tag] = np.asarray(L, np.float64)
np.savez(sys.argv[2], **out)
"""


def jax_results(tags, tmp_path: Path) -> dict:
    """{tag: the JAX package's per-lane radiance (N, 3) float64 of
    LANE_JOBS[tag] on material_grid's camera rays at RES, SPP (lane n the
    pixel n mod RES^2, sample n div RES^2), or for "sppm" its render of
    SPPM_ITERATIONS iterations at depth SPPM_DEPTH}, with the camera rays
    as "o" and "d", computed in one subprocess without FMA contraction."""
    (tmp_path / "jobs.json").write_text(json.dumps(list(tags)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]))
    subprocess.run([sys.executable, "-c", _JAX_LANES, str(tmp_path / "jobs.json"),
                    str(tmp_path / "out.npz")], env=env, check=True, timeout=900, cwd=ROOT)
    return dict(np.load(tmp_path / "out.npz"))
