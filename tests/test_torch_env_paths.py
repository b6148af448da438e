"""rs_pbrt_tpu_torch's integrators on quadric_env (tools/env_scenes.py:
a ground disk, a clipped cylinder, a mirror sphere and a box, an annulus
and a cylinder area light, and the sky as an infinite light) against the
JAX package's on the same camera rays and Sobol' indices: path (power and
spatial light selection, the latter on 16 voxels along the scene's
longest axis), volpath, whitted and directlighting ("all" and "one") per
lane at 16x16, 2 spp, depth 5, and SPPM's image at 16x16, 2 iterations,
depth 3 (tests/_envscene.py, the sky at 64 x 128); path
regeneration under the sky per path equal to the fixed-depth loop on a
small statue; and env_scenes.build's tables through the port's builder
against the JAX builder's.

Tolerances: per lane and the SPPM image rtol = atol = 2e-3
(test_torch_path_general.py's bound: the same estimator and samples with
float association the only difference), against the JAX results computed
without FMA contraction in a subprocess; regeneration bit-equal to the
fixed-depth loop (each path takes the same samples and arithmetic); the
tables allclose 1e-6 (test_torch_scene.py's), the map and its transforms
equal, the importance tables rtol 1e-5 (the cumulative sums' order).
"""

import numpy as np
import pytest
import torch

import _envscene as E
import _volpath as V
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.models import lightdistrib
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import direct
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import regen
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.models.integrators import volpath
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import env_scenes
from test_torch_scene import assert_tables_equal

torch.set_num_threads(2)

TAGS = ("path", "path_spatial", "volpath", "whitted", "dl_all", "dl_one")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return E.jax_results(TAGS + ("sppm",), tmp_path_factory.mktemp("env_paths"))


def _port_lanes(tag, scene, o, d):
    integrator, opt = E.LANE_JOBS[tag]
    scfg, ctx = V.sample_ctx(E.RES, E.SPP)
    pcfg = pathmod.PathCfg(E.DEPTH, 1.0)
    if integrator == "path":
        ld = (lightdistrib.build_spatial(scene, max_voxels=E.SPATIAL_VOXELS)
              if opt.get("spatial") else None)
        return pathmod.radiance(scene, pcfg, scfg, ctx, o, d, light_distrib=ld)
    if integrator == "volpath":
        return volpath.radiance(scene, pcfg, scfg, ctx, o, d)
    if integrator == "whitted":
        return direct.whitted_radiance(scene, direct.WhittedCfg(E.DEPTH), scfg, ctx, o, d)
    return direct.directlighting_radiance(
        scene, direct.DirectLightingCfg(E.DEPTH, opt["sample_all"]), scfg, ctx, o, d)


@pytest.mark.parametrize("tag", TAGS)
def test_radiance_matches_jax(tag, jax_results):
    scene, _ = E.port_scene()
    assert scene.has_env and scene.has_quadric_lights and scene.quad_kind_mask == 7
    got = _port_lanes(tag, scene, torch.as_tensor(jax_results["o"]),
                      torch.as_tensor(jax_results["d"])).numpy()
    want = jax_results[tag]
    assert got.shape == want.shape and np.isfinite(got).all() and want.mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_sppm_matches_jax(jax_results):
    """Photons from the sky and the quadric lights; the camera pass adds
    no sky on escape, as the JAX package's does not."""
    scene, camera = E.port_scene()
    st = {}
    cfg = rdr.RenderCfg("sppm", 1, E.SPPM_DEPTH, 1.0,
                        extra=dict(n_iterations=E.SPPM_ITERATIONS))
    got = rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, 1, (E.RES, E.RES)),
                     stats=st).numpy()
    want = jax_results["sppm"]
    assert got.shape == want.shape == (E.RES, E.RES, 3) and want.mean() > 0.05
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert st["iterations"] == E.SPPM_ITERATIONS


def test_regeneration_under_the_sky_equals_fixed_depth():
    """The 20,484-triangle statue under a 32 x 64 sky through its BVH: 512
    paths through 64 lanes give each path the fixed-depth loop's radiance."""
    scene, camera = env_scenes.statue_env((16, 16), subdivisions=5, sky_hw=(32, 64),
                                          device="cpu")
    accel = si.build_accel(scene, device="cpu")
    spp = 2
    scfg = smpl.make_sampler(smpl.SOBOL, spp, (16, 16))
    pcfg = pathmod.PathCfg(5, 1.0)
    assert scene.has_env and regen.eligible(scene, pcfg, scfg, accel, 512, lane_width=64)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, spp)
    st = {}
    got = regen.radiance_regen(scene, pcfg, scfg, ctx, rays.o, rays.d, accel, lane_width=64,
                               stats=st)
    want = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, accel)
    assert st["iterations"] > 6 and float(want.mean()) > 0.05 and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_build_tables_equal_jax():
    sky = env_scenes.sky_map(*E.SKY_HW)
    scene = env_scenes.build(SceneBuilder(), sky).finalize("cpu")
    jscene = env_scenes.build(JaxBuilder(), sky).finalize()
    assert_tables_equal(scene, jscene)
    np.testing.assert_allclose(scene.sph_attr.numpy(), np.asarray(jscene.sph_attr), rtol=1e-6,
                               atol=1e-6)
    for k in ("inf_radiance", "inf_l2w", "inf_w2l"):
        np.testing.assert_array_equal(getattr(scene, k).numpy(), np.asarray(getattr(jscene, k)),
                                      err_msg=k)
    for k in ("cond_func", "cond_cdf", "cond_func_int", "marg_func", "marg_cdf", "marg_func_int"):
        np.testing.assert_allclose(getattr(scene.inf_dist, k).numpy(),
                                   np.asarray(getattr(jscene.inf_dist, k)), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert (scene.has_env, scene.has_quadric_lights, scene.quad_kind_mask) == (
        jscene.has_env, jscene.has_quadric_lights, jscene.quad_kind_mask)
