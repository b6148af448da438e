"""rs_pbrt_tpu_torch's triangle sweeps (the plain versions of K3, K4 and K5)
and its scene intersection against the JAX package, on the same rays.

Tolerances are those the JAX package holds its own Pallas sweeps to
(tests/test_pallas.py:43-91): K3 and K5 against the XLA brute force,
valid and triangle ids equal, t within rtol 1e-5, barycentrics within
atol 1e-5 and the record rows within rtol = atol = 1e-4 (the port
normalizes by a reciprocal where XLA divides); K4 exactly equal to the
brute force and to the Pallas kernel run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import intersect as jisect
from rs_pbrt_tpu.ops import pallas_intersect as jpin
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene import presets as jpresets
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu.utils import vecmath as jvm
from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import presets
from test_torch_scene import bridge

torch.set_num_threads(2)


def random_tris(n_tri, seed):
    """A scene of n_tri random triangles in the box [-2, 2]^3 (the JAX
    builder's table), some with vertex normals, some reversed."""
    rng = np.random.default_rng(seed)
    b = JaxBuilder()
    for k in range(n_tri):
        pos = rng.uniform(-2.0, 2.0, (3, 3))
        nrm = rng.normal(size=(3, 3)) if k % 3 == 0 else None
        b.add_triangle_mesh([[0, 1, 2]], pos, normals=nrm, material=0,
                            reverse_orientation=k % 5 == 0)
    return b.finalize()


def cases():
    return {
        "cornell": (jpresets.cornell_box((8, 8))[0], (50.0, 500.0)),
        "random": (random_tris(48, 3), (-2.5, 2.5)),
    }


# t against the brute force: rtol 1e-5 as tests/test_pallas.py:55 holds the
# TPU kernel on the Cornell box; 2e-5 on the random triangles, where one
# grazing ray's t differs by 1.3e-5 between the brute force's form and the
# TPU kernel's own (interpreted, and the port's, which agrees with it to
# 1e-6)
T_RTOL = {"cornell": 1e-5, "random": 2e-5}


def rays(lo, hi, n=512, seed=7):
    """Random origins in [lo, hi]^3 and directions; a fifth of the rays end
    at a finite t_max, the rest run to FLT_MAX as camera rays do; four rays
    have a zero direction (a shadow ray of length 0)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = 0.0
    t_max = np.where(rng.uniform(size=n) < 0.2, 0.5 * (hi - lo), jvm.INFINITY).astype(np.float32)
    return o, d, t_max


def torch_args(o, d, t_max, jscene):
    return (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
            torch.tensor(np.asarray(jscene.tri_attr)), jscene.n_tris)


def jax_brute(jscene, o, d, t_max):
    return jisect.intersect_tris_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                       jscene.tri_p0, jscene.tri_p1, jscene.tri_p2)


@pytest.mark.parametrize("case", ["cornell", "random"])
def test_closest_sweep_matches_brute(case):
    jscene, box = cases()[case]
    o, d, t_max = rays(*box)
    got = ik.closest_sweep_plain(*torch_args(o, d, t_max, jscene))
    want = jax_brute(jscene, o, d, t_max)
    v = np.asarray(want.valid)
    assert 0.2 < v.mean() < 1.0
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=T_RTOL[case])
    np.testing.assert_allclose(got.b0.numpy()[v], np.asarray(want.b0)[v], atol=1e-5)
    np.testing.assert_allclose(got.b1.numpy()[v], np.asarray(want.b1)[v], atol=1e-5)


@pytest.mark.parametrize("case", ["cornell", "random"])
def test_any_sweep_matches_brute_and_tpu_kernel(case, monkeypatch):
    """Equal to the XLA brute force and to the TPU kernel, interpreted.  A
    ray of zero direction counts as occluded in all three (its NaN edge
    functions pass every reject test)."""
    monkeypatch.setenv("RS_PBRT_PALLAS_INTERPRET", "1")
    jscene, box = cases()[case]
    o, d, t_max = rays(*box)
    got = ik.any_sweep_plain(*torch_args(o, d, t_max, jscene)).numpy()
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    brute = np.asarray(jisect.intersect_tris_brute_p(jo, jd, jt, jscene.tri_p0, jscene.tri_p1,
                                                     jscene.tri_p2))
    kernel = np.asarray(jpin.pallas_intersect_tris_p(jo, jd, jt, jscene.tri_p0, jscene.tri_p1,
                                                     jscene.tri_p2))
    assert 0.05 < got.mean() < 1.0 and got[:4].all()
    np.testing.assert_array_equal(got, brute)
    np.testing.assert_array_equal(got, kernel)


@pytest.mark.parametrize("case", ["cornell", "random"])
def test_full_sweep_matches_tri_interaction(case):
    """K5's plain version against the brute force and the unfused record
    (tests/test_pallas.py:69-91), and its misses as the TPU kernel writes
    them: t = t_max, prim -1, mat 0, light -1."""
    jscene, box = cases()[case]
    o, d, t_max = rays(*box)
    fh = ik.full_sweep_plain(*torch_args(o, d, t_max, jscene))
    bh = jax_brute(jscene, o, d, t_max)
    tp, tperr, tng, tns, tuv, tmat, tlight, tdpdu = jsi._tri_interaction(
        jscene, jnp.asarray(o), jnp.asarray(d), bh)
    v = np.asarray(bh.valid)
    np.testing.assert_array_equal(fh.valid.numpy(), v)
    np.testing.assert_array_equal(fh.ids[ik.I_PRIM].numpy(), np.asarray(bh.tri))
    np.testing.assert_allclose(fh.rows[ik.F_T].numpy(), np.asarray(bh.t), rtol=T_RTOL[case])
    for row, width, ref in ((ik.F_P, 3, tp), (ik.F_P_ERR, 3, tperr), (ik.F_NG, 3, tng),
                            (ik.F_NS, 3, tns), (ik.F_UV, 2, tuv), (ik.F_DPDU, 3, tdpdu)):
        np.testing.assert_allclose(fh.vec(row, width).numpy()[v], np.asarray(ref)[v],
                                   rtol=1e-4, atol=1e-4, err_msg=str(row))
    np.testing.assert_array_equal(fh.ids[ik.I_MAT].numpy()[v], np.asarray(tmat)[v])
    np.testing.assert_array_equal(fh.ids[ik.I_LIGHT].numpy()[v], np.asarray(tlight)[v])
    assert (fh.ids[ik.I_MAT].numpy()[~v] == 0).all() and (fh.ids[ik.I_LIGHT].numpy()[~v] == -1).all()
    assert (fh.rows[1:, torch.as_tensor(~v)] == 0).all()


def test_wrappers_take_plain_on_cpu():
    """On CPU tensors each wrapper is its plain version and counts nothing."""
    jscene, box = cases()["random"]
    args = torch_args(*rays(*box), jscene)
    before = dict(ik.launches)
    for fn, plain in ((ik.closest_sweep, ik.closest_sweep_plain),
                      (ik.any_sweep, ik.any_sweep_plain), (ik.full_sweep, ik.full_sweep_plain)):
        got, want = fn(*args), plain(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
    assert ik.launches == before


def spheres_scenes():
    jscene, jcamera = jpresets.spheres_direct((16, 16))
    return presets.spheres_direct((16, 16), device="cpu")[0], jscene, jcamera


def camera_rays(jcamera, spp=2):
    """Camera rays of the whole grid through the JAX camera."""
    from rs_pbrt_tpu.models import cameras as jcam
    from rs_pbrt_tpu.models import samplers as jsmpl

    w, h = jcamera.resolution
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pix = jnp.asarray(np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1)), jnp.int32)
    cfg = jsmpl.make_sampler(jsmpl.SOBOL, spp, (w, h))
    ctx = jsmpl.make_ctx(cfg, pix, jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), w * h),
                         frame_lt_spp=True)
    u_film, u_time, u_lens = jsmpl.get_camera_dims(cfg, ctx, ctx.pixel)
    r = jcam.generate_rays(jcamera, pix.astype(jnp.float32) + u_film, u_lens, u_time)
    return np.asarray(r.o), np.asarray(r.d)


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_scene_intersect_spheres_direct(kind):
    """Triangles and spheres: the port's Interaction and shadow query
    against the JAX package's on the same rays."""
    scene, jscene, jcamera = spheres_scenes()
    if kind == "camera":
        o, d = camera_rays(jcamera)
        t_max = np.full(o.shape[0], jvm.INFINITY, np.float32)
    else:
        o, d, t_max = rays(-3.0, 3.0, n=2048, seed=11)
        o[:, 1] = np.abs(o[:, 1]) + 0.05  # above the floor
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    it = si.scene_intersect(scene, *args)
    jit = jsi.scene_intersect(jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    v = np.asarray(jit.valid)
    assert 0.3 < v.mean() and (np.asarray(jit.prim) >= jscene.n_tris).any()  # spheres hit
    for k in ("valid", "mat", "light", "prim"):
        np.testing.assert_array_equal(getattr(it, k).numpy(), np.asarray(getattr(jit, k)), k)
    np.testing.assert_allclose(it.t.numpy(), np.asarray(jit.t), rtol=1e-5)
    for k in ("p", "p_error", "ng", "ns", "uv", "wo", "dpdu"):
        np.testing.assert_allclose(getattr(it, k).numpy()[v], np.asarray(getattr(jit, k))[v],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    hit = si.dense_tri_hit(scene, *args)  # K3 over the scene's triangles
    jhit = jsi._dense_tri_hit(jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(jhit.tri))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(jhit.t), rtol=1e-5)
    occ = si.scene_intersect_p(scene, *args).numpy()
    jocc = np.asarray(jsi.scene_intersect_p(jscene, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(t_max)))
    np.testing.assert_array_equal(occ, jocc)


def test_unported_geometry_raises():
    """Cylinders and disks reach scene_from_numpy but not the intersection."""
    b = JaxBuilder()
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    b.add_cylinder(jtr.translate([0, 0, 2]))
    scene = bridge(b.finalize())
    assert scene.quad_kind_mask == 1 << sa.QK_CYLINDER
    z = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError, match="cylinders"):
        si.scene_intersect(scene, z, z + 1.0, torch.ones(4))
    scene.quad_kind_mask, scene.n_tris = 0, si.BRUTE_FORCE_MAX_TRIS + 1
    with pytest.raises(NotImplementedError, match="BVH"):
        si.scene_intersect_p(scene, z, z + 1.0, torch.ones(4))


@pytest.mark.slow
@pytest.mark.parametrize("case", ["cornell", "random"])
def test_sweeps_match_interpreted_tpu_kernels(case, monkeypatch):
    """K3 and K5 plain against the Pallas kernels in interpret mode."""
    monkeypatch.setenv("RS_PBRT_PALLAS_INTERPRET", "1")
    jscene, box = cases()[case]
    o, d, t_max = rays(*box)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    args = torch_args(o, d, t_max, jscene)
    got = ik.closest_sweep_plain(*args)
    want = jpin.pallas_intersect_tris(jo, jd, jt, jscene.tri_p0, jscene.tri_p1, jscene.tri_p2)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    fh = ik.full_sweep_plain(*args)
    rec = jpin.pallas_intersect_tris_full(jo, jd, jt, jscene.tri_attr, jscene.n_tris)
    np.testing.assert_array_equal(fh.ids.numpy(), np.stack([np.asarray(rec[k]) for k in
                                                            ("prim", "mat", "light")]))
    want_rows = np.concatenate([np.asarray(rec["t"])[None]] + [
        np.asarray(rec[k]).T for k in ("p", "p_err", "ng", "ns", "uv", "dpdu")])
    np.testing.assert_allclose(fh.rows.numpy(), want_rows, rtol=1e-4, atol=1e-4)
