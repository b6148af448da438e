"""Shared set-up of the port's render tests of the samplers: the Cornell box
at a small size, and the JAX package's per-lane radiance of an integrator
with a sampler kind on it, computed in one subprocess whose XLA contracts
no FMAs (XLA_FLAGS=--xla_cpu_max_isa=SSE4_2, as tests/_volpath.py computes
its lanes).  Each test file sends its jobs to one subprocess, which draws
the camera rays with each job's sampler; the port renders on those rays
with its own sampler context and its own camera rays are held to them.

A job is (integrator, kind, depth, options); lane n is pixel n mod RES^2,
sample n div RES^2.  options["scene"] = "grid_hetero" puts the job in
tests/_volpath.py's scattering grid medium instead of the Cornell box.  "sppm" jobs render the image at SPPM_ITERATIONS
iterations with 1 spp, so the camera pass's sample numbers (the iteration
numbers) pass spp.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

RES, SPP = 12, 4
SPPM_ITERATIONS = 2
KINDS = {"zerotwo": 2, "stratified": 3, "halton": 4, "maxmin": 5}  # samplers.py's numbers

_JAX_LANES = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
import _volpath as V
from rs_pbrt_tpu.models import cameras, samplers
from rs_pbrt_tpu.models.integrators import direct as jdirect
from rs_pbrt_tpu.models.integrators import path as jpath
from rs_pbrt_tpu.models.integrators import render as rdr
from rs_pbrt_tpu.models.integrators import volpath as jvol
from rs_pbrt_tpu.scene import presets
from rs_pbrt_tpu.scene.builder import SceneBuilder
from rs_pbrt_tpu.utils import transform as tr
jobs = json.load(open(sys.argv[1]))
res, spp = jobs.pop("_res_spp")
cornell = presets.cornell_box(resolution=(res, res))
xs, ys = np.meshgrid(np.arange(res), np.arange(res))
pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1))
snum = np.repeat(np.arange(spp), res * res)
out = {}
for tag, (integrator, kind, depth, opt) in jobs.items():
    scene, camera = cornell
    if opt.get("scene") == "grid_hetero":
        eye, look, up, fov = V.camera_args("grid_hetero")
        scene = V.grid(SceneBuilder(), tr, V.hetero_density(), sigma_s=0.3, g=0.3).finalize()
        camera = cameras.make_perspective(tr.look_at(eye, look, up), (res, res), fov=fov)
    if integrator == "sppm":
        cfg = rdr.RenderCfg("sppm", 1, depth, 1.0, extra=dict(n_iterations=opt["iterations"]))
        out[tag] = np.asarray(rdr.render(scene, camera, cfg,
                                         samplers.make_sampler(kind, 1, (res, res))), np.float64)
        continue
    scfg = samplers.make_sampler(kind, spp, (res, res))
    ctx = samplers.make_ctx(scfg, jnp.asarray(pix, jnp.int32), jnp.asarray(snum, jnp.uint32),
                            frame_lt_spp=True)
    rays, _, _ = rdr._camera_rays(camera, scfg, ctx, ctx.pixel)
    o, d = rays.o, rays.d
    if integrator == "path":
        L = jpath.radiance(scene, jpath.PathCfg(depth, 1.0), scfg, ctx, o, d, None, regen=False)
    elif integrator == "volpath":
        L = jvol.radiance(scene, jpath.PathCfg(depth, 1.0), scfg, ctx, o, d, None)
    elif integrator == "whitted":
        L = jdirect.whitted_radiance(scene, jdirect.WhittedCfg(depth), scfg, ctx, o, d)
    elif integrator == "ao":
        L = jdirect.ao_radiance(scene, jdirect.AOCfg(opt["n_samples"], True), scfg, ctx, o, d)
    else:
        L = jdirect.directlighting_radiance(
            scene, jdirect.DirectLightingCfg(depth, opt["sample_all"]), scfg, ctx, o, d)
    out[tag] = np.asarray(L, np.float64)
    out[tag + ":o"], out[tag + ":d"] = np.asarray(o), np.asarray(d)
np.savez(sys.argv[2], **out)
"""


def jax_lanes(jobs: dict, tmp_path: Path) -> dict:
    """{tag: the JAX package's per-lane radiance (N, 3) float64 of
    jobs[tag] = (integrator, kind, depth, options) on the Cornell box at
    RES, SPP, with its camera rays as "tag:o" and "tag:d"; for an "sppm"
    job its image}, computed in one subprocess without FMA contraction."""
    spec = dict(jobs, _res_spp=[RES, SPP])
    (tmp_path / "jobs.json").write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]))
    subprocess.run([sys.executable, "-c", _JAX_LANES, str(tmp_path / "jobs.json"),
                    str(tmp_path / "out.npz")], env=env, check=True, timeout=900, cwd=ROOT)
    return dict(np.load(tmp_path / "out.npz"))


def port_result(job, tag: str, res: dict) -> np.ndarray:
    """The port's per-lane radiance of job on its scene (its image for
    "sppm"), on the CPU.  Its camera rays (render.camera_rays with the
    job's sampler) are held to the JAX ones at 1e-5 first; the radiance is
    taken on the JAX rays."""
    from rs_pbrt_tpu_torch.models import cameras as cam
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import direct
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.models.integrators import volpath
    from rs_pbrt_tpu_torch.scene import presets
    from rs_pbrt_tpu_torch.utils import transform as tr

    import _volpath as V

    integrator, kind, depth, opt = job
    if opt.get("scene") == "grid_hetero":
        eye, look, up, fov = V.camera_args("grid_hetero")
        scene = V.port_scene("grid_hetero", RES)
        camera = cam.make_perspective(tr.look_at(eye, look, up), (RES, RES), fov=fov,
                                      device="cpu")
    else:
        scene, camera = presets.cornell_box((RES, RES), device="cpu")
    if integrator == "sppm":
        cfg = rdr.RenderCfg("sppm", 1, depth, 1.0, extra=dict(n_iterations=opt["iterations"]))
        return rdr.render(scene, camera, cfg, smpl.make_sampler(kind, 1, (RES, RES))).numpy()
    scfg = smpl.make_sampler(kind, SPP, (RES, RES))
    ctx, rays = rdr.camera_rays(camera, scfg, 0, SPP)
    o, d = torch.as_tensor(res[tag + ":o"]), torch.as_tensor(res[tag + ":d"])
    np.testing.assert_allclose(rays.o.numpy(), o.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rays.d.numpy(), d.numpy(), rtol=1e-5, atol=1e-5)
    if integrator == "path":
        L = pathmod.radiance(scene, pathmod.PathCfg(depth, 1.0), scfg, ctx, o, d)
    elif integrator == "volpath":
        L = volpath.radiance(scene, pathmod.PathCfg(depth, 1.0), scfg, ctx, o, d)
    elif integrator == "whitted":
        L = direct.whitted_radiance(scene, direct.WhittedCfg(depth), scfg, ctx, o, d)
    elif integrator == "ao":
        L = direct.ao_radiance(scene, direct.AOCfg(opt["n_samples"], True), scfg, ctx, o, d)
    else:
        L = direct.directlighting_radiance(
            scene, direct.DirectLightingCfg(depth, opt["sample_all"]), scfg, ctx, o, d)
    return L.numpy()


def check(jobs: dict, tag: str, res: dict):
    """The port's result of jobs[tag] within rtol = atol = 2e-3 of the JAX
    one, per lane (per pixel for "sppm"), finite and not black."""
    got, want = port_result(jobs[tag], tag, res), res[tag]
    assert got.shape == want.shape and np.isfinite(got).all() and want.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
