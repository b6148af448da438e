"""Shared set-up of the port's tests on the quadric and environment scenes
(rs_pbrt_tpu_torch/tools/env_scenes.py): the scene at a small size
through either package's builder, the port's Sobol' context, and the JAX
package's per-lane radiance of each integrator and its SPPM render,
computed in one subprocess whose XLA contracts no FMAs
(XLA_FLAGS=--xla_cpu_max_isa=SSE4_2), as tests/_volpath.py computes them:
in the pytest process XLA contracts products and sums into fused
multiply-adds, which the port does not, and a lane whose Russian roulette
or lobe choice sits on a rounding boundary then takes the other branch.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

RES, SPP, DEPTH = 16, 2, 5
SKY_HW = (64, 128)  # the tests' sky map: 64 x 128 texels
AO_SAMPLES = 8  # the JAX render's default (render.py:90-96)
SPPM_ITERATIONS = 2
SPPM_DEPTH = 3
# the spatial light distribution's voxels along the longest axis: the
# ground disk makes the scene's box 40 units wide, and at the default 64
# its 64^3 voxels take a minute to estimate on the CPU
SPATIAL_VOXELS = 16

# tag -> (integrator, options); the per-lane jobs of the JAX subprocess
LANE_JOBS = {
    "path": ("path", {}),
    "path_spatial": ("path", {"spatial": True}),
    "volpath": ("volpath", {}),
    "whitted": ("whitted", {}),
    "dl_all": ("directlighting", {"sample_all": True}),
    "dl_one": ("directlighting", {"sample_all": False}),
    "ao_cos": ("ao", {"cos_sample": True}),
    "ao_uniform": ("ao", {"cos_sample": False}),
}


def port_scene():
    """quadric_env at RES on the CPU through the port's builder, with the
    sky at SKY_HW: (scene, camera)."""
    from rs_pbrt_tpu_torch.tools import env_scenes

    return env_scenes.quadric_env((RES, RES), sky_hw=SKY_HW, device="cpu")


_JAX_LANES = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
import _envscene as E
from rs_pbrt_tpu.models import cameras, lightdistrib, samplers
from rs_pbrt_tpu.models.integrators import direct as jdirect
from rs_pbrt_tpu.models.integrators import path as jpath
from rs_pbrt_tpu.models.integrators import render as rdr
from rs_pbrt_tpu.models.integrators import volpath as jvol
from rs_pbrt_tpu.scene.builder import SceneBuilder
from rs_pbrt_tpu.utils import transform as tr
from rs_pbrt_tpu_torch.tools import env_scenes
jobs = json.load(open(sys.argv[1]))
scene = env_scenes.build(SceneBuilder(), env_scenes.sky_map(*E.SKY_HW)).finalize()
res, spp, depth = E.RES, E.SPP, E.DEPTH
camera = cameras.make_perspective(tr.look_at(*env_scenes.CAMERA[:3]), (res, res),
                                  fov=env_scenes.CAMERA[3])
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
        ld = (lightdistrib.build_spatial(scene, max_voxels=E.SPATIAL_VOXELS)
              if opt.get("spatial") else None)
        L = jpath.radiance(scene, pcfg, scfg, ctx, o, d, None, light_distrib=ld, regen=False)
    elif integrator == "volpath":
        L = jvol.radiance(scene, pcfg, scfg, ctx, o, d, None)
    elif integrator == "whitted":
        L = jdirect.whitted_radiance(scene, jdirect.WhittedCfg(depth), scfg, ctx, o, d)
    elif integrator == "directlighting":
        L = jdirect.directlighting_radiance(
            scene, jdirect.DirectLightingCfg(depth, opt["sample_all"]), scfg, ctx, o, d)
    else:
        L = jdirect.ao_radiance(scene, jdirect.AOCfg(E.AO_SAMPLES, opt["cos_sample"]), scfg,
                                ctx, o, d)
    out[tag] = np.asarray(L, np.float64)
np.savez(sys.argv[2], **out)
"""


def jax_results(tags, tmp_path: Path) -> dict:
    """{tag: the JAX package's per-lane radiance (N, 3) float64 of
    LANE_JOBS[tag] on quadric_env's camera rays at RES, SPP (lane n the
    pixel n mod RES^2, sample n div RES^2), or for "sppm" its render of
    SPPM_ITERATIONS iterations at depth SPPM_DEPTH}, with the camera rays
    as "o" and "d", computed in one subprocess without FMA contraction."""
    (tmp_path / "jobs.json").write_text(json.dumps(list(tags)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]))
    subprocess.run([sys.executable, "-c", _JAX_LANES, str(tmp_path / "jobs.json"),
                    str(tmp_path / "out.npz")], env=env, check=True, timeout=900, cwd=ROOT)
    return dict(np.load(tmp_path / "out.npz"))
