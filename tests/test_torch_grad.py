"""rs_pbrt_tpu_torch's differentiable rendering (diff/grad.py) against the
JAX package's, the cases of tests/test_grad.py at a smaller size.

- The Cornell box at 8x8, 2 spp, depth 3: grad_loss of the image's mean
  in mat_params and light_emission, within rtol 2e-3 (atol 1e-5 x the
  largest |g|) of the JAX gradient; an unused parameter's gradient 0; the
  white wall's kd red and the light's red emission within rtol 5e-2 of the
  port's own central finite difference (tests/test_grad.py's steps).
- grad_loss_wrt_camera at depth 2: the camera matrices' gradients against
  the JAX package's at the same tolerance; the translation's y and z
  within 0.08 of a central finite difference (the x translation is
  dominated by silhouettes, which detached sampling does not model).
- The two textured quads at 8x8, depth 1: tex_atlas and tex_params
  against the JAX gradient, and the strongest texel and the constant's
  value against a finite difference.
- K2 is never launched under a gradient; a gradient render through a
  kernel without a backward (a curve scene's C3, the realistic camera's
  L1) raises NotImplementedError naming ROADMAP A17c.
- grad_loss(mesh=) over a world of one equals grad_loss bit for bit.
- The camera gradient of a 5,124-triangle statue through its BVH and
  through its kd-tree (the walks' plain versions forward, G1's twin
  backward), each against the JAX package's gradient through its dense
  sweep at rtol 2e-3, and against each other at rtol 1e-4.
The JAX side runs in two subprocesses (tests/_gradscene.py), one
value_and_grad compile a scene.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _gradscene import CAMERA, CORNELL, QUAD, QUAD_LOOK, STATUE, jax_jobs, quad_build
from rs_pbrt_tpu_torch.diff import grad as dg
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import path_kernel as pk
from rs_pbrt_tpu_torch.ops import texture as tx
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)

RTOL = 2e-3  # the port's gradient against the JAX package's
ATOL = 1e-5  # x the largest |g|
FD_RTOL = 5e-2  # tests/test_grad.py's
CAM_FD_RTOL = 0.08
MEAN = lambda img: img.mean()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    jax = jax_jobs(tmp_path_factory.mktemp("grad"),
                   {"cornell": ("grad", dict(CORNELL, scene="cornell")),
                    "atlas": ("grad", dict(QUAD, scene="atlas"))},
                   {"camera": ("camera", CAMERA), "value": ("grad", dict(QUAD, scene="value")),
                    "statue": ("camera", STATUE)})
    yield jax
    jax.close()


def setup(o, scene_cam):
    scene, camera = scene_cam
    cfg = rdr.RenderCfg("path", o["spp"], o["depth"], 1.0)
    return scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, o["spp"], camera.resolution)


def cornell(o):
    return setup(o, presets.cornell_box((o["res"], o["res"]), device="cpu"))


def quad(kind):
    b, tid = quad_build(SceneBuilder(), tx, kind)
    eye, at, up, fov = QUAD_LOOK
    camera = cam.make_perspective(tr.look_at(eye, at, up), (QUAD["res"],) * 2, fov=fov,
                                  device="cpu")
    return setup(QUAD, (b.finalize("cpu"), camera)) + (tid,)


def close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * float(np.abs(want).max()))


def fd(scene, camera, cfg, scfg, params, leaf, index, h):
    """The port's central finite difference of the mean in one leaf."""
    def val(delta):
        arr = getattr(params, leaf).clone()
        arr[index] += delta
        img = dg.render_image(scene, camera, cfg, scfg, params._replace(**{leaf: arr}))
        return float(MEAN(img))

    return (val(h) - val(-h)) / (2 * h)


@pytest.fixture(scope="module")
def cornell_grad():
    scene, camera, cfg, scfg = cornell(CORNELL)
    params = dg.get_params(scene)
    return (scene, camera, cfg, scfg, params) + dg.grad_loss(scene, camera, cfg, scfg, MEAN,
                                                              params)


def test_cornell_params_match_jax(cornell_grad, jax_side):
    """The port's DiffParams, loss and gradient in mat_params and
    light_emission against the JAX package's; K2 never launches."""
    scene, _, _, _, params, loss, g = cornell_grad
    res = jax_side.results("cornell")
    jax_params = dg.diff_params_from_numpy([res["cornell:p_" + k] for k in dg.DiffParams._fields],
                                           "cpu")
    for a, b in zip(params, jax_params):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(loss), float(res["cornell:loss"]), rtol=1e-5)
    close(g.mat_params, res["cornell:g_mat_params"])
    close(g.light_emission, res["cornell:g_light_emission"])
    assert float(g.mat_params[:, sa.MP_ETA3].abs().sum()) == 0.0  # an unused slot
    assert np.isfinite(g.mat_params.numpy()).all()


def test_k2_refused_under_grad():
    """mega_cfg takes the Cornell box, and refuses it once a table tracks
    a gradient (the JAX gate refuses tracers); the bounce kernel's wrapper
    is never reached."""
    scene, _ = presets.cornell_box((4, 4), device="cpu")
    assert pk.mega_cfg(scene) is not None
    p = dg.get_params(scene)
    tracked = dg.apply_params(scene, p._replace(mat_params=p.mat_params.requires_grad_(True)))
    assert pk.mega_cfg(tracked) is None
    with torch.no_grad():
        assert pk.mega_cfg(tracked) is not None


@pytest.mark.parametrize("leaf,index,h", [("mat_params", (1, sa.MP_KD), 5e-3),
                                         ("light_emission", (0, 0), 0.25)])
def test_cornell_ad_matches_fd(cornell_grad, leaf, index, h):
    """The white wall's kd red and the light's red emission: AD within
    rtol 5e-2 of the port's central finite difference on the same
    samples."""
    scene, camera, cfg, scfg, params, _, g = cornell_grad
    ad = float(getattr(g, leaf)[index])
    assert ad > 0.0
    np.testing.assert_allclose(ad, fd(scene, camera, cfg, scfg, params, leaf, index, h),
                               rtol=FD_RTOL)


def test_camera_grad_matches_jax_and_fd(jax_side):
    """grad_loss_wrt_camera: both matrices' gradients against the JAX
    package's; the translation's y and z against a central difference."""
    scene, camera, cfg, scfg = cornell(CAMERA)
    loss, g = dg.grad_loss_wrt_camera(scene, camera, cfg, scfg, MEAN)
    res = jax_side.results("camera")
    np.testing.assert_allclose(float(loss), float(res["camera:loss"]), rtol=1e-5)
    close(g.cam_to_world, res["camera:g_cam_to_world"])
    close(g.raster_to_camera, res["camera:g_raster_to_camera"])
    h, base, fdv = 0.05, camera.cam_to_world.clone(), np.zeros(3)
    for k in range(3):
        for sgn in (1.0, -1.0):
            m = base.clone()
            m[k, 3] += sgn * h
            img = rdr.render(scene, dataclasses.replace(camera, cam_to_world=m), cfg, scfg)
            fdv[k] += sgn * float(MEAN(img)) / (2 * h)
    g_t = g.cam_to_world[:3, 3].numpy()
    for k in (1, 2):
        assert abs(g_t[k] - fdv[k]) / max(abs(fdv[k]), 1e-6) < CAM_FD_RTOL, (k, g_t, fdv)


@pytest.mark.parametrize("kind", ["atlas", "value"])
def test_texture_grads_match_jax_and_fd(kind, jax_side):
    """The textured quads: tex_atlas (through T1 and T2's plain versions)
    and tex_params against the JAX gradient; the strongest texel, or the
    constant's red value, against the port's central difference (the JAX
    test's steps)."""
    scene, camera, cfg, scfg, tid = quad(kind)
    params = dg.get_params(scene)
    _, g = dg.grad_loss(scene, camera, cfg, scfg, MEAN, params)
    res = jax_side.results(kind)
    close(g.tex_atlas, res[f"{kind}:g_tex_atlas"])
    close(g.tex_params, res[f"{kind}:g_tex_params"])
    if kind == "atlas":
        flat = g.tex_atlas.abs().sum(-1)
        iy, ix = np.unravel_index(int(flat.argmax()), flat.shape)
        index, leaf, h = (iy, ix, 0), "tex_atlas", 5e-2
    else:
        index, leaf, h = (tid, tx.TP_VALUE), "tex_params", 2e-2
    ad = float(getattr(g, leaf)[index])
    assert ad != 0.0
    np.testing.assert_allclose(ad, fd(scene, camera, cfg, scfg, params, leaf, index, h),
                               rtol=FD_RTOL)


def test_raising_wrappers_name_a17c():
    """A camera gradient through a kernel without a backward raises: the
    curve sweep C3 of a hair scene, and the realistic camera's L1."""
    from rs_pbrt_tpu_torch.tools import hair_scenes

    scene, camera = hair_scenes.hair_patch((4, 4), device="cpu")
    cfg = rdr.RenderCfg("path", 1, 1, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, 1, (4, 4))
    with pytest.raises(NotImplementedError, match="A17c"):
        dg.grad_loss_wrt_camera(scene, camera, cfg, scfg, MEAN)
    scene, _ = presets.cornell_box((4, 4), device="cpu")
    lens = (50.0, 5.0, 1.5, 20.0, -50.0, 45.0, 1.0, 20.0)
    camera = cam.make_realistic(tr.look_at((278, 273, -800), (278, 273, 0), (0, 1, 0)), (4, 4),
                                lens, aperture_diameter=8.0, focus_distance=1078.0,
                                film_diag_mm=35.0, device="cpu")
    with pytest.raises(NotImplementedError, match="A17c"):
        dg.grad_loss_wrt_camera(scene, camera, cfg, scfg, MEAN)


def test_sharded_grad_names_a17b():
    """grad_loss(mesh=) (ROADMAP A17b) over a world of one started in this
    process equals grad_loss bit for bit (tests/test_torch_parallel.py
    holds 4 ranks)."""
    from rs_pbrt_tpu_torch.parallel import mesh as pm

    scene, camera, cfg, scfg = cornell(dict(CORNELL, res=4, spp=1, depth=2))
    want_loss, want = dg.grad_loss(scene, camera, cfg, scfg, MEAN)
    mesh = pm.make_mesh("cpu")
    try:
        loss, got = dg.grad_loss(scene, camera, cfg, scfg, MEAN, mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(loss, want_loss)
    assert float(want.mat_params.abs().max()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_tree_walks_take_g1(jax_side):
    """The camera gradient of the 5,124-triangle statue through its BVH
    (B1's plain walk forward) and through its kd-tree (D1's), each with
    G1's twin for the backward, against the JAX package's gradient of the
    same statue through its dense sweep (the JAX package differentiates no
    tree walk, its while_loops being forward-only), and against each
    other."""
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.scene import bigscene

    scene, camera = bigscene.statue_scene((STATUE["res"],) * 2, STATUE["subdiv"], device="cpu")
    assert scene.n_tris > si.BRUTE_FORCE_MAX_TRIS
    cfg = rdr.RenderCfg("path", STATUE["spp"], STATUE["depth"], 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, STATUE["spp"], camera.resolution)
    accels = [si.build_accel(scene, kind, device="cpu") for kind in ("bvh", "kdtree")]
    assert si.uses_bvh(scene, accels[0]) and si.uses_kd(scene, accels[1])
    runs = [dg.grad_loss_wrt_camera(scene, camera, cfg, scfg, MEAN, accel=a) for a in accels]
    res = jax_side.results("statue")
    for loss, g in runs:
        np.testing.assert_allclose(float(loss), float(res["statue:loss"]), rtol=1e-5)
        close(g.cam_to_world, res["statue:g_cam_to_world"])
        close(g.raster_to_camera, res["statue:g_raster_to_camera"])
    grads = [g for _, g in runs]
    assert float(grads[0].cam_to_world.abs().max()) > 0.0
    close(grads[0].cam_to_world, grads[1].cam_to_world, 1e-4, 1e-6)
