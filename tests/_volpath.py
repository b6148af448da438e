"""Shared set-up of the port's tests of the volumetric path integrator and
of subsurface transport: the test scenes as calls on a scene builder (the
JAX package's SceneBuilder and the port's take the same calls), and the
JAX package's per-lane radiance of such scenes computed in one subprocess
whose XLA contracts no FMAs (XLA_FLAGS=--xla_cpu_max_isa=SSE4_2, as
tests/_caustic.py runs the JAX renders).

Why a subprocess: in this process XLA's CPU compiler contracts products
and sums into fused multiply-adds, which the port does not; on the
dragonette a lane in ~250 then takes another branch (a probe that hits the
sphere or not, Russian roulette) and its estimate differs wholly.  Without
the contraction the two packages round alike, and every lane agrees.
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

FLOOR = [[-100, 0, -100], [100, 0, -100], [100, 0, 100], [-100, 0, 100]]
WALL_Z = 5.0


def fog(b):
    """tests/test_integrators.py:114-135's scene: a matte floor under a
    point light, the camera in a homogeneous absorber (sigma_a 0.05)."""
    m = b.add_matte(kd=(0.6,) * 3)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], FLOOR, material=m)
    b.add_point_light(p=(0.0, 10.0, 0.0), I=(100.0,) * 3)
    b.camera_medium = b.add_medium(sigma_a=(0.05,) * 3, sigma_s=(0.0,) * 3)
    return b


def grid(b, tr, density, sigma_s=0.0, g=0.0):
    """tests/test_integrators.py:307-357's scene: the camera in a grid
    medium (sigma_a 0.2) spanning (-10, -10, -10) to (10, 10, 10), facing a
    two-sided emitting wall at z = 5.  tr: the transform module of the
    builder's package."""
    black = b.add_matte(kd=(0, 0, 0))
    z = WALL_Z
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-50, -50, z], [50, -50, z], [50, 50, z], [-50, 50, z]],
                        material=black, area_light=dict(L=(2.0,) * 3, two_sided=True))
    m2w = tr.compose(tr.translate([-10, -10, -10]), tr.scale(20, 20, 20))
    b.camera_medium = b.add_medium(sigma_a=(0.2,) * 3, sigma_s=(sigma_s,) * 3, g=g,
                                   density_grid=density, medium_to_world=m2w)
    return b


def hetero_density():
    """A seeded 8^3 grid of densities in [0.1, 1.9]."""
    return np.random.default_rng(11).uniform(0.1, 1.9, (8, 8, 8)).astype(np.float32)


# job name -> (scene, integrator, resolution, spp, depth); the JAX side
# builds the scene in the subprocess (_JAX_LANES), the port's test builds
# its own from the same calls
SCENES = {
    "cornell": ("cornell", "volpath", 16, 2, 5),
    "fog": ("fog", "volpath", 9, 4, 3),
    "grid_const": ("grid_const", "volpath", 9, 4, 2),
    "grid_hetero": ("grid_hetero", "volpath", 9, 4, 3),
    "dragonette": ("dragonette", "volpath", 16, 2, 6),
    "dragonette_path": ("dragonette", "path", 16, 2, 6),
}


def camera_args(scene: str):
    """(eye, look, up, fov) of the builder scenes' cameras."""
    if scene == "fog":
        return [0, 5, -10], [0, 0, 0], [0, 1, 0], 40.0
    return [0, 0, 0], [0, 0, WALL_Z], [0, 1, 0], 30.0


def port_scene(scene: str, res: int):
    """The port's scene of a SCENES entry on the CPU (the dragonette comes
    from dragonette_text through the JAX front end, see port_dragonette)."""
    from rs_pbrt_tpu_torch.scene import presets
    from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
    from rs_pbrt_tpu_torch.utils import transform as tr

    if scene == "cornell":
        return presets.cornell_box((res, res), device="cpu")[0]
    if scene == "fog":
        return fog(SceneBuilder()).finalize("cpu")
    density = np.ones((8, 8, 8), np.float32) if scene == "grid_const" else hetero_density()
    kw = {} if scene == "grid_const" else dict(sigma_s=0.3, g=0.3)
    return grid(SceneBuilder(), tr, density, **kw).finalize("cpu")


def dragonette_text(res: int, spp: int, integrator: str = "volpath") -> str:
    txt = (ROOT / "assets" / "scenes" / "sss_dragonette.pbrt").read_text()
    txt = txt.replace('"integer xresolution" 200', f'"integer xresolution" {res}')
    txt = txt.replace('"integer yresolution" 200', f'"integer yresolution" {res}')
    txt = txt.replace('"integer pixelsamples" 16', f'"integer pixelsamples" {spp}')
    return txt.replace('Integrator "volpath"', f'Integrator "{integrator}"')


def port_dragonette(path: Path):
    """The JAX front end's parse of the scene file at path, bridged into
    the port on the CPU: (scene, JAX camera)."""
    from rs_pbrt_tpu.scene.api import load_pbrt
    from test_torch_scene import bridge

    jscene, jcamera = load_pbrt(str(path), {})[:2]
    return bridge(jscene), jcamera


def sample_ctx(res: int, spp: int):
    """The port's Sobol' sampler config and context of the whole res x res
    grid at spp, lane n the pixel n mod res^2, sample n div res^2."""
    from rs_pbrt_tpu_torch.models import samplers as smpl

    xs, ys = np.meshgrid(np.arange(res), np.arange(res))
    pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1))
    snum = np.repeat(np.arange(spp), res * res)
    cfg = smpl.make_sampler(smpl.SOBOL, spp, (res, res))
    return cfg, smpl.make_ctx(cfg, torch.as_tensor(pix), torch.as_tensor(snum), frame_lt_spp=True)


_JAX_LANES = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
import _volpath as V
from rs_pbrt_tpu.models import cameras, samplers
from rs_pbrt_tpu.models.integrators import path as jpath
from rs_pbrt_tpu.models.integrators import render as rdr
from rs_pbrt_tpu.models.integrators import volpath as jvol
from rs_pbrt_tpu.scene import presets
from rs_pbrt_tpu.scene.api import load_pbrt
from rs_pbrt_tpu.scene.builder import SceneBuilder
from rs_pbrt_tpu.utils import transform as tr
jobs = json.load(open(sys.argv[1]))
out = {}
for tag, (scene_name, integrator, res, spp, depth, path) in jobs.items():
    if path:
        scene, camera = load_pbrt(path, {})[:2]
    elif scene_name == "cornell":
        scene, camera = presets.cornell_box(resolution=(res, res))
    else:
        if scene_name == "fog":
            b = V.fog(SceneBuilder())
        else:
            dens = np.ones((8, 8, 8), np.float32) if scene_name == "grid_const" else V.hetero_density()
            kw = {} if scene_name == "grid_const" else dict(sigma_s=0.3, g=0.3)
            b = V.grid(SceneBuilder(), tr, dens, **kw)
        scene = b.finalize()
        eye, look, up, fov = V.camera_args(scene_name)
        camera = cameras.make_perspective(tr.look_at(eye, look, up), (res, res), fov=fov)
    scfg = samplers.make_sampler(samplers.SOBOL, spp, (res, res))
    xs, ys = np.meshgrid(np.arange(res), np.arange(res))
    pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1))
    ctx = samplers.make_ctx(scfg, jnp.asarray(pix, jnp.int32),
                            jnp.asarray(np.repeat(np.arange(spp), res * res), jnp.uint32),
                            frame_lt_spp=True)
    rays, _, _ = rdr._camera_rays(camera, scfg, ctx, ctx.pixel)
    pcfg = jpath.PathCfg(depth, 1.0)
    if integrator == "volpath":
        L = jvol.radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, None)
    else:
        L = jpath.radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, None, regen=False)
    out[tag] = np.asarray(L, np.float64)
    out[tag + ":o"], out[tag + ":d"] = np.asarray(rays.o), np.asarray(rays.d)
np.savez(sys.argv[2], **out)
"""


def jax_lanes(tags, tmp_path: Path, files: dict = None) -> dict:
    """{tag: the JAX package's per-lane radiance (N, 3) float64 of
    SCENES[tag] on its camera rays, with the rays as "tag:o" and "tag:d"},
    computed in one subprocess without FMA contraction.  files: {tag: a
    scene file}, parsed by the JAX front end instead of the built scene."""
    spec = {t: list(SCENES[t]) + [str((files or {}).get(t, "")) or None] for t in tags}
    (tmp_path / "lanes.json").write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]))
    subprocess.run([sys.executable, "-c", _JAX_LANES, str(tmp_path / "lanes.json"),
                    str(tmp_path / "lanes.npz")], env=env, check=True, timeout=900, cwd=ROOT)
    return dict(np.load(tmp_path / "lanes.npz"))
