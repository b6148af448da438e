"""rs_pbrt_tpu_torch's path integrator with subsurface scattering
(models/integrators/path.py sss_transport) against the JAX package's path
integrator on the dragonette (assets/scenes/sss_dragonette.pbrt, parsed by
the JAX front end, 16x16, 2 spp, depth 6; the JAX radiance without FMA
contraction in a subprocess, tests/_volpath.py), and path regeneration
(regen.py) on a BVH scene with a subsurface material, where a bounce draws
7 + 8 dims.

Tolerances: per lane rtol = atol = 2e-3 against the JAX package (as
test_torch_path_general.py); the regeneration loop per path equal to the
fixed-depth loop (the same samples and ops on every path, lane by lane).
"""

import numpy as np
import pytest
import torch

import _volpath as V
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import regen
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import bigscene
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import sss_scenes
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)


def test_path_radiance_matches_jax(tmp_path):
    path = tmp_path / "dragonette_path.pbrt"
    path.write_text(V.dragonette_text(16, 2, "path"))
    lanes = V.jax_lanes(["dragonette_path"], tmp_path, files={"dragonette_path": path})
    scene = V.port_dragonette(path)[0]
    assert scene.has_subsurface and pathmod.dims_per_bounce(scene) == 15
    _, _, res, spp, depth = V.SCENES["dragonette_path"]
    scfg, ctx = V.sample_ctx(res, spp)
    got = pathmod.radiance(scene, pathmod.PathCfg(depth, 1.0), scfg, ctx,
                           torch.as_tensor(lanes["dragonette_path:o"]),
                           torch.as_tensor(lanes["dragonette_path:d"])).numpy()
    want = lanes["dragonette_path"]
    assert np.isfinite(got).all() and want.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def milk_statue(res):
    """A displaced icosphere of 5,120 triangles (above the brute-force
    limit: traversed through its BVH) of the subsurface material, on a
    matte ground, lit by a quad area light and a point light."""
    v, f = bigscene.icosphere(4)
    v = v * (1.0 + 0.18 * bigscene._fbm3(v))[:, None] * 0.6 + np.array([0.0, 0.7, 0.0])
    b = SceneBuilder()
    milk = b.add_subsurface(sigma_a=(0.02, 0.05, 0.1), sigma_s=(1.5, 2.0, 2.5))
    b.add_triangle_mesh(f, v, material=milk)
    ground = b.add_matte(kd=(0.4, 0.4, 0.4))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], [[-4, 0, -4], [-4, 0, 4], [4, 0, 4], [4, 0, -4]],
                        material=ground)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]],
                        material=b.add_matte(kd=(0, 0, 0)),
                        area_light=dict(L=(6.0, 6.0, 6.0)))
    b.add_point_light(p=(0, 1.5, -2.5), I=(20, 20, 20))
    camera = cam.make_perspective(tr.look_at([0, 1.0, 2.6], [0, 0.7, 0], [0, 1, 0]), (res, res),
                                  fov=40.0, device="cpu")
    return b.finalize("cpu"), camera


def test_regen_with_subsurface_equals_fixed_depth():
    res, spp = 8, 4
    scene, camera = milk_statue(res)
    accel = si.build_accel(scene, device="cpu")
    assert si.uses_bvh(scene, accel) and scene.has_subsurface
    scfg = smpl.make_sampler(smpl.SOBOL, spp, (res, res))
    pcfg = pathmod.PathCfg(5, 1.0)
    # 15 dims a bounce: depth 8 fits K1's 128, depth 9 does not (7 x 9 would)
    assert regen.eligible(scene, pathmod.PathCfg(8, 1.0), scfg, accel, 256, lane_width=64)
    assert not regen.eligible(scene, pathmod.PathCfg(9, 1.0), scfg, accel, 256, lane_width=64)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, spp)
    st = {}
    got = regen.radiance_regen(scene, pcfg, scfg, ctx, rays.o, rays.d, accel, lane_width=64,
                               stats=st)
    want = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, accel)
    assert st["iterations"] > 6 and float(want.mean()) > 0.01 and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_volpath_raises_on_an_environment_light():
    """Volpath renders an environment light and every other light: a
    goniometric light's tag in the mask no longer raises (the image is
    unchanged where no light has it)."""
    scene, camera = sss_scenes.sss_dragonette((4, 4), device="cpu")
    go = lambda: rdr.render(scene, camera, sss_scenes.CFG._replace(spp=1),
                            smpl.make_sampler(smpl.SOBOL, 1, (4, 4)))
    before = go()
    scene.light_type_mask |= 1 << sa.LIGHT_GONIO
    assert torch.equal(go(), before)
