"""rs_pbrt_tpu_torch's perspective camera and math substrate against the
JAX package, on the same inputs (made with numpy from a seed).

Rays agree to allclose 1e-5 (the port transforms points with elementwise
sums where the JAX package uses einsum); the vector helpers are
elementwise and agree to 1e-6 or exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import cameras as jcam
from rs_pbrt_tpu.ops import sampling as jsmp
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu.utils import vecmath as jvm
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.ops import sampling as smp
from rs_pbrt_tpu_torch.utils import transform as tr
from rs_pbrt_tpu_torch.utils import vecmath as vm

torch.set_num_threads(2)

VIEWS = [
    ((278, 273, -800), (278, 273, 0), (0, 1, 0), (32, 32), 39.3077),
    ((0, 1.5, -6), (0, 0.8, 0), (0, 1, 0), (12, 20), 60.0),
    ((3, -2, 5), (0.5, 0.2, -1), (0.3, 0.9, 0.1), (40, 24), 75.0),
]


@pytest.mark.parametrize("view", range(len(VIEWS)))
@pytest.mark.parametrize("lens_radius", [0.0, 0.25])
def test_generate_rays(view, lens_radius):
    eye, look, up, res, fov = VIEWS[view]
    c = cam.make_perspective(tr.look_at(eye, look, up), res, fov=fov, lens_radius=lens_radius,
                             focal_distance=7.5, device="cpu")
    jc = jcam.make_perspective(jtr.look_at(eye, look, up), res, fov=fov,
                               lens_radius=lens_radius, focal_distance=7.5)
    np.testing.assert_allclose(c.cam_to_world.numpy(), np.asarray(jc.cam_to_world), rtol=1e-6)
    np.testing.assert_allclose(c.raster_to_camera.numpy(), np.asarray(jc.raster_to_camera),
                               rtol=1e-6)
    rng = np.random.default_rng(view)
    n = 1000
    p_film = (rng.uniform(size=(n, 2)) * np.asarray(res)).astype(np.float32)
    u_lens = rng.uniform(size=(n, 2)).astype(np.float32)
    u_time = rng.uniform(size=n).astype(np.float32)
    got = cam.generate_rays(c, torch.as_tensor(p_film), torch.as_tensor(u_lens),
                            torch.as_tensor(u_time))
    want = jcam.generate_rays(jc, jnp.asarray(p_film), jnp.asarray(u_lens), jnp.asarray(u_time))
    for k in ("o", "d", "time", "weight"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-5 * (1 + np.abs(eye).max()), err_msg=k)


def test_camera_from_jax_fields():
    jc = jcam.make_perspective(jtr.look_at(*VIEWS[1][:3]), (12, 20), fov=60.0)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    c = cam.camera_from_numpy(fields, device="cpu")
    np.testing.assert_array_equal(c.raster_to_camera.numpy(), np.asarray(jc.raster_to_camera))
    assert c.resolution == (12, 20)
    ortho = jcam.make_orthographic(jtr.look_at(*VIEWS[1][:3]), (12, 20))
    c = cam.camera_from_numpy({f.name: getattr(ortho, f.name) for f in dataclasses.fields(ortho)},
                              device="cpu")
    assert c.cam_type == cam.ORTHOGRAPHIC and c.resolution == (12, 20)
    np.testing.assert_array_equal(c.raster_to_camera.numpy(), np.asarray(ortho.raster_to_camera))
    rng = np.random.default_rng(4)
    p_film = (rng.uniform(size=(200, 2)) * np.asarray([12, 20])).astype(np.float32)
    u = rng.uniform(size=(200, 3)).astype(np.float32)
    got = cam.generate_rays(c, torch.as_tensor(p_film), torch.as_tensor(u[:, :2]),
                            torch.as_tensor(u[:, 2]))
    want = jcam.generate_rays(ortho, jnp.asarray(p_film), jnp.asarray(u[:, :2]),
                              jnp.asarray(u[:, 2]))
    for k in ("o", "d", "time", "weight"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-5 * 7, err_msg=k)
    clipped = jcam.make_perspective(jtr.look_at(*VIEWS[1][:3]), (12, 20), clipping_start=0.5)
    with pytest.raises(NotImplementedError):
        cam.camera_from_numpy({f.name: getattr(clipped, f.name)
                               for f in dataclasses.fields(clipped)}, device="cpu")


def test_transforms():
    for t, jt in ((tr.perspective(45.0, 1e-2, 1000.0), jtr.perspective(45.0, 1e-2, 1000.0)),
                  (tr.compose(tr.translate([1, 2, 3]), tr.scale(2, 3, 4)),
                   jtr.compose(jtr.translate([1, 2, 3]), jtr.scale(2, 3, 4))),
                  (tr.inverse(tr.look_at(*VIEWS[2][:3])), jtr.inverse(jtr.look_at(*VIEWS[2][:3])))):
        np.testing.assert_array_equal(t.m, np.asarray(jt.m))
        np.testing.assert_array_equal(t.m_inv, np.asarray(jt.m_inv))
    m = np.asarray(tr.look_at(*VIEWS[2][:3]).m)
    p = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(tr.xform_point(torch.as_tensor(m), torch.as_tensor(p)).numpy(),
                               np.asarray(jtr.xform_point(jnp.asarray(m), jnp.asarray(p))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.xform_vector(torch.as_tensor(m), torch.as_tensor(p)).numpy(),
                               np.asarray(jtr.xform_vector(jnp.asarray(m), jnp.asarray(p))),
                               rtol=1e-6, atol=1e-6)


def test_vecmath():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(size=200) * 100, [0.0, -0.0, np.inf, -np.inf]]).astype(np.float32)
    for f, jf in ((vm.next_float_up, jvm.next_float_up), (vm.next_float_down, jvm.next_float_down)):
        np.testing.assert_array_equal(f(torch.as_tensor(x)).numpy(), np.asarray(jf(jnp.asarray(x))))
    assert vm.gamma(3.0) == jvm.gamma(3.0)
    v = rng.normal(size=(300, 3)).astype(np.float32)
    n = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    err = np.abs(rng.normal(size=(300, 3)) * 1e-3).astype(np.float32)
    w = rng.normal(size=(300, 3)).astype(np.float32)
    tv, tn, te, tw = map(torch.as_tensor, (v, n, err, w))
    np.testing.assert_allclose(vm.normalize(tv).numpy(), np.asarray(jvm.normalize(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-7)
    for got, want in zip(vm.coordinate_system(tn), jvm.coordinate_system(jnp.asarray(n))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        vm.offset_ray_origin(tv, te, tn, tw).numpy(),
        np.asarray(jvm.offset_ray_origin(*map(jnp.asarray, (v, err, n, w)))), rtol=1e-6, atol=1e-7)


def test_sampling():
    u = np.random.default_rng(2).uniform(size=(500, 2)).astype(np.float32)
    u[:3] = 0.5  # the zero-offset branch
    np.testing.assert_allclose(smp.concentric_sample_disk(torch.as_tensor(u)).numpy(),
                               np.asarray(jsmp.concentric_sample_disk(jnp.asarray(u))),
                               rtol=1e-6, atol=1e-7)
    f, g = np.random.default_rng(3).uniform(0, 2, (2, 100)).astype(np.float32)
    f[:5] = g[:5] = 0.0
    np.testing.assert_allclose(smp.power_heuristic(torch.as_tensor(f), torch.as_tensor(g)).numpy(),
                               np.asarray(jsmp.power_heuristic(1, jnp.asarray(f), 1, jnp.asarray(g))),
                               rtol=1e-6)
    for func in ([3.0, 0.5, 1.5], [0.0, 0.0, 0.0, 0.0], [2.0]):  # all-zero -> uniform
        d = smp.make_distribution_1d(torch.tensor(func))
        jd = jsmp.make_distribution_1d(jnp.asarray(func, jnp.float32))
        for k in ("func", "cdf", "func_int"):
            np.testing.assert_allclose(getattr(d, k).numpy(), np.asarray(getattr(jd, k)),
                                       rtol=1e-6, err_msg=k)
