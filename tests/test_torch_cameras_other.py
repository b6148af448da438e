"""rs_pbrt_tpu_torch's orthographic, environment and realistic cameras and
camera motion against the JAX package, on the same inputs (made with numpy
from a seed).

Tolerances: rays allclose 1e-5 (atol 1e-5 times the scene's scale), as
tests/test_torch_camera.py holds the perspective camera; the realistic
camera's vignetting flag (weight > 0) agrees on at least 99.9% of lanes
(its compares can flip on one ulp at an element's edge), the other lanes
at the same tolerance; the animated transform's decomposition and the
realistic camera's host arrays (lens rows, traces, focusing, exit pupil)
bit-equal (the same numpy float64 code); the interpolated matrices 1e-6.
csrc/lens.cuh (L1's per-lane math), built for the host with g++ without
FMA contraction, against the plain version: the same vignetting flags,
o, d and weights within 1e-6 (the host's libm and torch's CPU kernels may
round a square root or a quotient's last bit otherwise).
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import cameras as jcam
from rs_pbrt_tpu.models import realistic as jrl
from rs_pbrt_tpu.utils import animated as janim
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import realistic as rl
from rs_pbrt_tpu_torch.ops import lens_kernel as lk
from rs_pbrt_tpu_torch.utils import animated as anim
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parent.parent / "rs_pbrt_tpu_torch" / "csrc"
# biconvex singlet (tests/test_realistic.py:16): R = +-50 mm, 5 mm thick,
# n = 1.5; no stop, so the aperture diameter changes nothing
SINGLET = [50.0, 5.0, 1.5, 20.0, -50.0, 45.0, 1.0, 20.0]
# the singlet with an aperture stop 5 mm behind it (12 mm, cut to the
# aperture diameter): the trace's stop branch and a refraction into air
STOPPED = [50.0, 5.0, 1.5, 20.0, -50.0, 5.0, 1.0, 20.0, 0.0, 40.0, 0.0, 12.0]
LENSES = {"singlet": SINGLET, "stopped": STOPPED}
CORNELL = ((278, 273, -800), (278, 273, 0), (0, 1, 0))
RES = (24, 16)


def fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


def lanes(n, res, seed):
    rng = np.random.default_rng(seed)
    p_film = (rng.uniform(size=(n, 2)) * np.asarray(res)).astype(np.float32)
    p_film[:4] = [[0, 0], [res[0] / 2, res[1] / 2], [res[0], res[1]], [res[0] / 2, 0]]
    return (p_film, rng.uniform(size=(n, 2)).astype(np.float32),
            rng.uniform(size=n).astype(np.float32))


def both_rays(c, jc, n=4000, seed=0):
    p, u, t = lanes(n, c.resolution, seed)
    got = cam.generate_rays(c, *map(torch.as_tensor, (p, u, t)))
    want = jcam.generate_rays(jc, *map(jnp.asarray, (p, u, t)))
    return got, want


def assert_rays(got, want, scale, realistic=False):
    keep = np.ones(got.o.shape[0], bool)
    if realistic:
        ok_got, ok_want = got.weight.numpy() > 0, np.asarray(want.weight) > 0
        assert (ok_got != ok_want).mean() <= 1e-3
        assert 0.3 < ok_want.mean() < 1.0  # vignetting is live
        keep = ok_got == ok_want
    for k in ("o", "d", "time", "weight"):
        np.testing.assert_allclose(getattr(got, k).numpy()[keep],
                                   np.asarray(getattr(want, k))[keep], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


# --- the animated transform's camera half ---------------------------------

def _motion_ends(kind):
    """Two shutter ends: a rotation, a translation and a scale apart."""
    a = tr.look_at(*CORNELL)
    if kind == "rts":
        b = tr.compose(tr.look_at((300, 290, -760), (260, 280, 0), (0.1, 1, 0)),
                       tr.scale(1.1, 0.95, 1.05))
    elif kind == "flip":  # a half turn: the quaternion's trace <= 0 branch
        b = tr.compose(a, tr.from_matrix(np.diag([-1.0, -1.0, 1.0, 1.0])))
    else:  # "near": nearly equal ends, the slerp's lerp branch
        b = tr.compose(a, tr.translate([0.5, 0.0, 0.0]))
    return a, b


@pytest.mark.parametrize("kind", ["rts", "flip", "near"])
def test_decompose_and_interpolate(kind):
    a, b = _motion_ends(kind)
    for m in (a.m, b.m):
        for got, want in zip(anim.decompose(m), janim.decompose(m)):
            np.testing.assert_array_equal(got, want)
    parts = anim.decompose(a.m) + anim.decompose(b.m)
    t = np.random.default_rng(1).uniform(-0.2, 1.2, 500).astype(np.float32)
    got = anim.interpolate(torch.as_tensor(t), *(torch.as_tensor(x) for x in parts))
    want = janim.interpolate(jnp.asarray(t), *parts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6 * 800)


# --- the realistic camera's host half -------------------------------------

@pytest.mark.parametrize("lens,aperture", [("singlet", 8.0), ("stopped", 8.0),
                                           ("stopped", 20.0)])
def test_realistic_host_bit_equal(lens, aperture):
    data = LENSES[lens]
    el, jel = rl.parse_lens_data(data, aperture), jrl.parse_lens_data(data, aperture)
    np.testing.assert_array_equal(el, jel)
    focus = rl.focus_thick_lens(el, 1078.0, 0.035)
    assert focus == jrl.focus_thick_lens(jel, 1078.0, 0.035)
    el[-1, 1] = jel[-1, 1] = focus
    rng = np.random.default_rng(2)
    o = np.c_[rng.normal(0, 0.005, (300, 2)), np.zeros(300)]
    d = np.c_[rng.normal(0, 0.2, (300, 2)), np.full(300, focus)]
    for f, jf in ((rl.trace_from_film_np, jrl.trace_from_film_np),
                  (rl.trace_from_scene_np, jrl.trace_from_scene_np)):
        for got, want in zip(f(el, o, d), jf(jel, o, d)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rl.bound_exit_pupil(el, 0.001, 0.002, 64),
                                  jrl.bound_exit_pupil(jel, 0.001, 0.002, 64))
    # the whole 64-bin table (~5 s a side): test_make_realistic_matches
    np.testing.assert_array_equal(rl.build_exit_pupil_bounds(el, 0.035, n_bins=4),
                                  jrl.build_exit_pupil_bounds(jel, 0.035, n_bins=4))


@pytest.fixture(scope="module")
def realistic_cams():
    """{(lens, aperture): the JAX realistic camera on the Cornell view at
    RES, focused at 1078 (the box's middle), film diagonal 35 mm}."""
    return {key: jcam.make_realistic(jtr.look_at(*CORNELL), RES, LENSES[key[0]],
                                     aperture_diameter=key[1], focus_distance=1078.0,
                                     film_diag_mm=35.0)
            for key in (("singlet", 8.0), ("singlet", 20.0), ("stopped", 8.0), ("stopped", 20.0))}


def test_make_realistic_matches(realistic_cams):
    """The port's make_realistic gives the JAX camera's fields."""
    jc = realistic_cams[("stopped", 8.0)]
    c = cam.make_realistic(tr.look_at(*CORNELL), RES, STOPPED, aperture_diameter=8.0,
                           focus_distance=1078.0, film_diag_mm=35.0, device="cpu")
    np.testing.assert_array_equal(c.lens.numpy(), np.asarray(jc.lens, np.float32))
    np.testing.assert_array_equal(c.pupil_bounds.numpy(), np.asarray(jc.pupil_bounds, np.float32))
    np.testing.assert_array_equal(c.cam_to_world.numpy(), np.asarray(jc.cam_to_world))
    assert (c.cam_type, c.film_diag, c.simple_weighting, c.resolution) == (
        cam.REALISTIC, jc.film_diag, True, RES)


@pytest.mark.parametrize("simple", [True, False])
@pytest.mark.parametrize("lens,aperture", [("singlet", 8.0), ("singlet", 20.0), ("stopped", 8.0),
                                           ("stopped", 20.0)])
def test_realistic_rays(realistic_cams, lens, aperture, simple):
    jc = realistic_cams[(lens, aperture)].replace(simple_weighting=simple, shutter_open=0.25,
                                                  shutter_close=0.75)
    c = cam.camera_from_numpy(fields(jc), device="cpu")
    got, want = both_rays(c, jc, seed=int(aperture) + 2 * simple)
    assert_rays(got, want, 800.0, realistic=True)


def test_lens_host_build_matches_plain(realistic_cams, tmp_path):
    """csrc/lens.cuh compiled for the host (g++ -ffp-contract=off) gives
    the plain version's rays lane for lane: the stopped lens, both
    weightings."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler to build lens.cuh")
    src = tmp_path / "lens_host.cpp"
    src.write_text('#define RS_HD inline\n#include "lens.cuh"\n'
                   'extern "C" void trace(const float* cl, const float* el, int n_el, '
                   'const float* pupil, const float* m, const float* p, const float* u, int n, '
                   'float* o, float* d, float* w) {\n'
                   '  for (int i = 0; i < n; ++i) lens::trace_lane(cl, el, n_el, pupil, m, '
                   'p[2 * i], p[2 * i + 1], u[2 * i], u[2 * i + 1], o + 3 * i, d + 3 * i, w + i);\n'
                   '}\n')
    lib = tmp_path / "liblens_host.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(CSRC), str(src), "-o", str(lib)], check=True, timeout=120)
    trace = ctypes.CDLL(str(lib)).trace
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    for simple in (True, False):
        jc = realistic_cams[("stopped", 8.0)].replace(simple_weighting=simple)
        c = cam.camera_from_numpy(fields(jc), device="cpu")
        p, u, _ = lanes(20000, RES, 7)
        n = p.shape[0]
        o, d = np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32)
        w = np.zeros(n, np.float32)
        k = c.lens_consts
        trace(ptr(k.lane), ptr(k.el), k.el.shape[0], ptr(k.pupil), ptr(k.m), ptr(p), ptr(u), n,
              ptr(o), ptr(d), ptr(w))
        want = lk.lens_rays_plain(c, torch.as_tensor(p), torch.as_tensor(u))
        np.testing.assert_array_equal(w > 0, want[2].numpy() > 0)
        assert 0.2 < (w > 0).mean() < 0.9
        for got, ref in zip((o, d, w), want):
            np.testing.assert_allclose(got, ref.numpy(), rtol=1e-6, atol=1e-6)


# --- the projective and environment cameras -------------------------------

def _jax_and_port(kind):
    view = tr.look_at(*CORNELL), jtr.look_at(*CORNELL)
    if kind in ("ortho", "ortho_dof"):
        kw = dict(screen_window=(-300.0, 300.0, -200.0, 200.0), shutter_open=0.1,
                  shutter_close=0.6)
        if kind == "ortho_dof":
            kw.update(lens_radius=25.0, focal_distance=900.0)
        return jcam.make_orthographic(view[1], RES, **kw)
    if kind == "env":
        return jcam.make_environment(jtr.look_at((278, 273, 280), (278, 273, 560), (0, 1, 0)),
                                     RES, shutter_open=0.3, shutter_close=0.4)
    if kind == "persp_frame":
        return jcam.make_perspective(view[1], RES, fov=45.0, lens_radius=12.0,
                                     focal_distance=1000.0, shutter_open=0.2, shutter_close=0.7,
                                     frame_aspect=1.25, screen_window=(-1.1, 0.9, -0.8, 0.7))
    if kind == "persp_aspect":  # frame_aspect below 1: the tall window
        return jcam.make_perspective(view[1], RES, fov=60.0, frame_aspect=0.8)
    a, b = _motion_ends("rts")
    ja, jb = jtr.from_matrix(a.m), jtr.from_matrix(b.m)
    if kind == "persp_motion":
        return jcam.make_perspective(ja, RES, fov=39.3, cam_to_world_end=jb, shutter_open=0.0,
                                     shutter_close=0.5)
    # ortho_motion: the JAX make_orthographic takes no end; its anim field does
    c = jcam.make_orthographic(ja, RES, screen_window=(-300.0, 300.0, -200.0, 200.0))
    return c.replace(anim=jcam._anim_tuple(ja, jb))


@pytest.mark.parametrize("kind", ["ortho", "ortho_dof", "env", "persp_frame", "persp_aspect",
                                  "persp_motion", "ortho_motion"])
def test_generate_rays(kind):
    jc = _jax_and_port(kind)
    c = cam.camera_from_numpy(fields(jc), device="cpu")
    np.testing.assert_array_equal(c.raster_to_camera.numpy(), np.asarray(jc.raster_to_camera))
    got, want = both_rays(c, jc, seed=len(kind))
    assert_rays(got, want, 800.0)
    if kind.endswith("motion"):  # the ends differ, so the rays move with u_time
        still = cam.generate_rays(dataclasses.replace(c, anim=()), *map(
            torch.as_tensor, lanes(4000, RES, len(kind))))
        assert (still.o - got.o).abs().max() > 1.0


def test_port_constructors_match_jax():
    """The port's make_* give the JAX cameras' fields."""
    view, jview = tr.look_at(*CORNELL), jtr.look_at(*CORNELL)
    a, b = _motion_ends("rts")
    pairs = [
        (cam.make_orthographic(view, RES, screen_window=(-300.0, 300.0, -200.0, 200.0),
                               device="cpu"),
         jcam.make_orthographic(jview, RES, screen_window=(-300.0, 300.0, -200.0, 200.0))),
        (cam.make_environment(view, RES, shutter_open=0.3, device="cpu"),
         jcam.make_environment(jview, RES, shutter_open=0.3)),
        (cam.make_perspective(a, RES, fov=39.3, cam_to_world_end=b, frame_aspect=0.8,
                              shutter_close=0.5, device="cpu"),
         jcam.make_perspective(jtr.from_matrix(a.m), RES, fov=39.3, frame_aspect=0.8,
                               cam_to_world_end=jtr.from_matrix(b.m), shutter_close=0.5)),
    ]
    for c, jc in pairs:
        assert c.cam_type == jc.cam_type and c.resolution == jc.resolution
        np.testing.assert_array_equal(c.raster_to_camera.numpy(), np.asarray(jc.raster_to_camera))
        np.testing.assert_array_equal(c.cam_to_world.numpy(), np.asarray(jc.cam_to_world))
        assert (c.shutter_open, c.shutter_close) == (float(jc.shutter_open),
                                                     float(jc.shutter_close))
        assert len(c.anim) == 6 * bool(jc.anim)
        for got, want in zip(c.anim, [x for end in jc.anim for x in end]):
            np.testing.assert_array_equal(got.numpy().ravel(), np.asarray(want, np.float32))


def test_near_clipping_raises():
    with pytest.raises(NotImplementedError, match="A18"):
        cam.make_perspective(tr.look_at(*CORNELL), RES, clipping_start=5.0, device="cpu")
    jc = jcam.make_perspective(jtr.look_at(*CORNELL), RES, clipping_start=5.0)
    with pytest.raises(NotImplementedError, match="A18"):
        cam.camera_from_numpy(fields(jc), device="cpu")


def test_lens_rays_checks_arguments(realistic_cams):
    c = cam.camera_from_numpy(fields(realistic_cams[("singlet", 8.0)]), device="cpu")
    p = torch.zeros((8, 2))
    with pytest.raises(ValueError, match="u_lens"):
        lk.lens_rays(c, p, torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="p_film"):
        lk.lens_rays(c, p.double(), torch.zeros((8, 2)))
    many = dataclasses.replace(c, lens=torch.zeros((lk.MAX_ELEMENTS + 1, 4)))
    with pytest.raises(ValueError, match="elements"):
        lk.lens_rays(many, p, torch.zeros((8, 2)))


def test_lens_consts_follow_the_camera(realistic_cams):
    """L1's constants are built with the camera, and anew when a field
    changes: the other weighting's rays are the JAX camera's with it."""
    c = cam.camera_from_numpy(fields(realistic_cams[("stopped", 8.0)]), device="cpu")
    k = c.lens_consts
    assert k.el.shape == (3, 8) and k.pupil.shape == (lk.N_BINS, 4) and k.lane[-1] == 1.0
    np.testing.assert_array_equal(k.m, c.cam_to_world.numpy())
    other = dataclasses.replace(c, simple_weighting=False)
    assert other.lens_consts.lane[-1] == 0.0
    np.testing.assert_array_equal(other.lens_consts.el, k.el)
    jc = realistic_cams[("stopped", 8.0)].replace(simple_weighting=False)
    got, want = both_rays(other, jc, seed=5)
    assert_rays(got, want, 800.0, realistic=True)
    assert cam.make_environment(tr.look_at(*CORNELL), RES, device="cpu").lens_consts is None


def test_what_still_raises_names_its_item():
    """What the port still refuses raises NotImplementedError naming its
    ROADMAP item: near clipping (A18b, above); measured subsurface presets
    build since A18a.  bdpt and mlt (A16b) pass check_cfg and render with every
    camera type through the pinhole importance, as the JAX package does:
    the orthographic raster plane lies at z = 0, so its image area is
    infinite, the camera's pdf 0 ends every camera walk and the image is
    black; the environment camera's raster_to_camera is the identity, its
    area NaN.  The kd-tree (A25) builds and its RenderCfg passes."""
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.scene import presets
    from rs_pbrt_tpu_torch.scene.builder import SceneBuilder

    scene, _ = presets.cornell_box((8, 8), device="cpu")
    scfg = smpl.make_sampler(smpl.RANDOM, 1, (8, 8))
    for integrator in ("bdpt", "mlt"):
        cfg = rdr.RenderCfg(integrator, 1, 2, 1.0,
                            extra=dict(mutations_per_pixel=1, chains=16, bootstrap_samples=32))
        rdr.check_cfg(cfg)
        ortho = cam.make_orthographic(tr.look_at(*CORNELL), (8, 8), device="cpu")
        env = cam.make_environment(tr.look_at(*CORNELL), (8, 8), device="cpu")
        assert ortho.image_area == float("inf") and np.isnan(env.image_area)
        img = rdr.render(scene, ortho, cfg, scfg)
        assert img.shape == (8, 8, 3) and torch.equal(img, torch.zeros_like(img))
        assert rdr.render(scene, env, cfg, scfg).shape == (8, 8, 3)
    rdr.check_cfg(rdr.RenderCfg("path", 1, 5, 1.0, accelerator="kdtree"))
    scene, _ = presets.cornell_box((8, 8), device="cpu")
    assert si.build_accel(scene, kind="kdtree", device="cpu") == si.Accel()
    b = SceneBuilder()
    b.add_subsurface(name="Skin1")
    assert b.finalize("cpu").has_subsurface
