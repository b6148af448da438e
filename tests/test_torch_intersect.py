"""rs_pbrt_tpu_torch's triangle sweeps (the plain versions of K3, K4 and K5)
and its scene intersection against the JAX package, on the same rays.

Tolerances are those the JAX package holds its own Pallas sweeps to
(tests/test_pallas.py:43-91): K3 and K5 against the XLA brute force,
valid and triangle ids equal, t within rtol 1e-5, barycentrics within
atol 1e-5 and the record rows within rtol = atol = 1e-4 (the port
normalizes by a reciprocal where XLA divides); K4 exactly equal to the
brute force and to the Pallas kernel run in interpret mode.  The cases
beyond the Cornell box and 48 random triangles (n_tri of 0, 1 and 300,
rays of zero direction, rows with an infinite or a NaN vertex) reach the
paths of the K3/K4 kernels' design: t there within rtol 2e-5 and atol
1e-6 of the brute force (T_TOL).
"""

import functools
from typing import NamedTuple

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
from rs_pbrt_tpu_torch.ops import watertight as wt
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


class Case(NamedTuple):
    """A sweep input: the port's table and the JAX scene of the rows the
    references sweep.  The references never sweep a row with an infinite or
    NaN vertex: the brute force's index form and the one-hot form of the
    TPU kernels and the port differ there (test_index_form_*), and the
    JAX record gathers rows by a one-hot product, 0 * inf = NaN."""

    jscene: object  # the JAX scene of the table's finite rows
    box: tuple  # the rays' origins lie in [lo, hi]^3
    table: np.ndarray  # (T, N_TRI_ATTR) f32, swept over rows 0 .. n_tri-1
    n_tri: int
    rows: np.ndarray  # the table row of each of jscene's triangles
    zero_every: int = 0  # rays of zero direction: every k-th, else the first 4


CHUNK = 256  # table rows the K3/K4 kernels stage at a time (csrc/intersect.cu)
# the mixed tables' non-finite rows: (row, column, value), inserted among
# 44 finite rows; an infinite vertex coordinate, and a NaN one last
INF_ROWS = ((3, 2, np.inf), (17, 4, -np.inf), (30, 8, np.inf))
NAN_ROW = (47, 1, np.nan)


def _finite(jscene, box, n_tri=None, zero_every=0):
    table = np.array(jscene.tri_attr, np.float32)
    return Case(jscene, box, table, jscene.n_tris if n_tri is None else n_tri,
                np.arange(jscene.n_tris), zero_every)


def _mixed(bad):
    """44 random finite rows with the bad rows inserted at their places:
    each a copy of a finite row with one vertex coordinate replaced."""
    jscene = random_tris(44, 8)
    finite = np.asarray(jscene.tri_attr, np.float32)
    n = len(finite) + len(bad)
    places = [row for row, _, _ in bad]
    rows = np.array([r for r in range(n) if r not in places])
    table = np.zeros((n, finite.shape[1]), np.float32)
    table[rows] = finite
    for k, (row, col, value) in enumerate(bad):
        table[row] = finite[k]
        table[row, col] = value
    return Case(jscene, (-2.5, 2.5), table, n, rows)


@functools.lru_cache(maxsize=None)
def case(name: str) -> Case:
    box = (-2.5, 2.5)
    return {
        "cornell": lambda: _finite(jpresets.cornell_box((8, 8))[0], (50.0, 500.0)),
        "random": lambda: _finite(random_tris(48, 3), box),
        # n_tri of 1, of 0, and above the kernels' chunk, not a multiple of it
        "one": lambda: _finite(random_tris(1, 4), box),
        "empty": lambda: _finite(random_tris(48, 3), box, n_tri=0),
        "tail": lambda: _finite(random_tris(CHUNK + 44, 5), box),
        # a quarter of the rays of zero direction, finite and FLT_MAX t_max
        "zero_dir": lambda: _finite(random_tris(48, 3), box, zero_every=4),
        # rows with an infinite vertex among finite ones; and a NaN vertex too
        "inf_rows": lambda: _mixed(INF_ROWS),
        "mixed": lambda: _mixed(INF_ROWS + (NAN_ROW,)),
    }[name]()


CASES = ["cornell", "random", "one", "empty", "tail", "zero_dir", "inf_rows", "mixed"]

# t against the brute force, (rtol, atol): rtol 1e-5 as tests/test_pallas.py:55
# holds the TPU kernel on the Cornell box; 2e-5 on the random triangles,
# where one grazing ray's t differs by 1.3e-5 between the brute force's form
# and the TPU kernel's own (interpreted, and the port's, which agrees with it
# to 1e-6).  The other cases add atol 1e-6: with 300 triangles some lie
# within 1e-3 of a ray's origin, and the two forms round the coordinates
# (near 2, an ulp of 2.4e-7) differently, up to 1.3e-7 in t
T_TOL = {"cornell": (1e-5, 0.0), "random": (2e-5, 0.0)}
DEFAULT_T_TOL = (2e-5, 1e-6)
# the share of rays with a hit: (K3's closest hit, K4's occlusion) within
HIT_SHARE = {"cornell": ((0.2, 1.0), (0.05, 1.0)), "one": ((0.001, 0.1), (0.01, 0.2)),
             "empty": ((0.0, 0.0), (0.0, 0.0)), "mixed": ((0.2, 1.0), (1.0, 1.0))}
DEFAULT_SHARE = ((0.2, 1.0), (0.05, 1.0))


def rays(lo, hi, n=512, seed=7, zero_every=0):
    """Random origins in [lo, hi]^3 and directions; a fifth of the rays end
    at a finite t_max, the rest run to FLT_MAX as camera rays do; four rays
    (or every zero_every-th) have a zero direction (a shadow ray of length
    0)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = 0.0
    if zero_every:
        d[::zero_every] = 0.0
    t_max = np.where(rng.uniform(size=n) < 0.2, 0.5 * (hi - lo), jvm.INFINITY).astype(np.float32)
    return o, d, t_max


def case_rays(c: Case):
    o, d, t_max = rays(*c.box, zero_every=c.zero_every)
    return o, d, t_max, ~(d != 0).any(-1)


def case_args(c: Case, o, d, t_max):
    return (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
            torch.tensor(c.table), c.n_tri)


def jax_brute(jscene, o, d, t_max):
    return jisect.intersect_tris_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                       jscene.tri_p0, jscene.tri_p1, jscene.tri_p2)


def reference_hit(c: Case, o, d, t_max):
    """The brute force over the case's finite rows (all misses where it
    sweeps none), its ids jscene's, and the same ids as table rows."""
    if c.n_tri == 0:
        n = o.shape[0]
        hit = jisect.TriHit(jnp.zeros(n, bool), jnp.asarray(t_max), jnp.full(n, -1, jnp.int32),
                            jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32))
    else:
        hit = jax_brute(c.jscene, o, d, t_max)
    tri = np.asarray(hit.tri)
    return hit, np.where(tri >= 0, c.rows[np.maximum(tri, 0)], -1)


def tpu_table(c: Case):
    """The case's table cut to its swept rows, as the TPU kernels' p0, p1, p2."""
    tab = jnp.asarray(c.table[:c.n_tri])
    return tab[:, 0:3], tab[:, 3:6], tab[:, 6:9]


@pytest.mark.parametrize("name", CASES)
def test_closest_sweep_matches_brute(name):
    """A ray of zero direction is a miss; a row with an infinite or NaN
    vertex never holds the closest hit (its t is NaN)."""
    c = case(name)
    o, d, t_max, zero = case_rays(c)
    got = ik.closest_sweep_plain(*case_args(c, o, d, t_max))
    want, tri = reference_hit(c, o, d, t_max)
    v = np.asarray(want.valid)
    lo, hi = HIT_SHARE.get(name, DEFAULT_SHARE)[0]
    assert lo <= v.mean() <= hi
    assert not got.valid.numpy()[zero].any()
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.tri.numpy(), tri)
    rtol, atol = T_TOL.get(name, DEFAULT_T_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.b0.numpy()[v], np.asarray(want.b0)[v], atol=1e-5)
    np.testing.assert_allclose(got.b1.numpy()[v], np.asarray(want.b1)[v], atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_any_sweep_matches_brute_and_tpu_kernel(name, monkeypatch):
    """Equal to the TPU kernel, interpreted, and to the XLA brute force on
    tables of finite rows.  A ray of zero direction counts as occluded in
    all three (its NaN edge functions pass every reject test), and so does
    every ray that meets a row with a NaN vertex, or with an infinite one
    where the one-hot shear gives 0 * inf = NaN.  The TPU kernel takes no
    empty table: with n_tri 0 no ray is occluded."""
    monkeypatch.setenv("RS_PBRT_PALLAS_INTERPRET", "1")
    c = case(name)
    o, d, t_max, zero = case_rays(c)
    got = ik.any_sweep_plain(*case_args(c, o, d, t_max)).numpy()
    lo, hi = HIT_SHARE.get(name, DEFAULT_SHARE)[1]
    assert lo <= got.mean() <= hi
    if c.n_tri == 0:
        assert not got.any()
        return
    assert got[zero].all()
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    kernel = np.asarray(jpin.pallas_intersect_tris_p(jo, jd, jt, *tpu_table(c)))
    np.testing.assert_array_equal(got, kernel)
    brute = np.asarray(jisect.intersect_tris_brute_p(jo, jd, jt, c.jscene.tri_p0,
                                                     c.jscene.tri_p1, c.jscene.tri_p2))
    if len(c.rows) == c.n_tri:
        np.testing.assert_array_equal(got, brute)
    else:  # the non-finite rows occlude more rays than the finite rows do
        assert (got >= brute).all() and (got > brute).any()


@pytest.mark.parametrize("name", CASES)
def test_full_sweep_matches_tri_interaction(name):
    """K5's plain version against the brute force and the unfused record
    (tests/test_pallas.py:69-91), and its misses as the TPU kernel writes
    them: t = t_max, prim -1, mat 0, light -1."""
    c = case(name)
    o, d, t_max, _ = case_rays(c)
    fh = ik.full_sweep_plain(*case_args(c, o, d, t_max))
    bh, tri = reference_hit(c, o, d, t_max)
    tp, tperr, tng, tns, tuv, tmat, tlight, tdpdu = jsi._tri_interaction(
        c.jscene, jnp.asarray(o), jnp.asarray(d), bh)
    v = np.asarray(bh.valid)
    np.testing.assert_array_equal(fh.valid.numpy(), v)
    np.testing.assert_array_equal(fh.ids[ik.I_PRIM].numpy(), tri)
    rtol, atol = T_TOL.get(name, DEFAULT_T_TOL)
    np.testing.assert_allclose(fh.rows[ik.F_T].numpy(), np.asarray(bh.t), rtol=rtol, atol=atol)
    for row, width, ref in ((ik.F_P, 3, tp), (ik.F_P_ERR, 3, tperr), (ik.F_NG, 3, tng),
                            (ik.F_NS, 3, tns), (ik.F_UV, 2, tuv), (ik.F_DPDU, 3, tdpdu)):
        np.testing.assert_allclose(fh.vec(row, width).numpy()[v], np.asarray(ref)[v],
                                   rtol=1e-4, atol=1e-4, err_msg=str(row))
    np.testing.assert_array_equal(fh.ids[ik.I_MAT].numpy()[v], np.asarray(tmat)[v])
    np.testing.assert_array_equal(fh.ids[ik.I_LIGHT].numpy()[v], np.asarray(tlight)[v])
    assert (fh.ids[ik.I_MAT].numpy()[~v] == 0).all() and (fh.ids[ik.I_LIGHT].numpy()[~v] == -1).all()
    assert (fh.rows[1:, torch.as_tensor(~v)] == 0).all()


def _pick(p, k):
    """Component k (a per-ray int tensor) of the 3 coordinates p."""
    return torch.where(k == 0, p[0], torch.where(k == 1, p[1], p[2]))


def index_form_edge_test(rc, p, t_lim):
    """watertight._edge_test with the sheared components picked by index,
    x = (p[kx] + sx p[kz]) - cx, y = (p[ky] + sy p[kz]) - cy, z = p[kz] - cz,
    as csrc/watertight.cuh's edges_reject<true> computes them; the rest term
    by term as the one-hot form."""
    kz = torch.where(rc.Sz[0] != 0, 0, torch.where(rc.Sz[1] != 0, 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)
    sx, sy = _pick(rc.Sx, kz), _pick(rc.Sy, kz)
    xs, ys, zs = [], [], []
    for v in range(3):
        pv = p[3 * v:3 * v + 3]
        pz = _pick(pv, kz)
        xs.append((_pick(pv, kx) + sx * pz) - rc.cx)
        ys.append((_pick(pv, ky) + sy * pz) - rc.cy)
        zs.append(rc.inv_dz * (pz - rc.cz))
    (x0, x1, x2), (y0, y1, y2), (z0s, z1s, z2s) = xs, ys, zs
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    det = e0 + e1 + e2
    t_scaled = e0 * z0s + e1 * z1s + e2 * z2s
    neg_det = det < 0.0
    miss_range = (neg_det & ((t_scaled >= 0.0) | (t_scaled < t_lim * det))) | (
        ~neg_det & ((t_scaled <= 0.0) | (t_scaled > t_lim * det)))
    mx = lambda a, b, c: torch.maximum(torch.maximum(a.abs(), b.abs()), c.abs())
    max_zt, max_xt, max_yt = mx(z0s, z1s, z2s), mx(x0, x1, x2), mx(y0, y1, y2)
    max_e = mx(e0, e1, e2)
    delta_z = wt.GAMMA3 * max_zt
    delta_x = wt.GAMMA5 * (max_xt + max_zt)
    delta_y = wt.GAMMA5 * (max_yt + max_zt)
    delta_e = 2.0 * (wt.GAMMA2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    c_eps = 3.0 * (wt.GAMMA3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e)
    reject = (neg & pos) | (det == 0.0) | miss_range
    return e0, e1, det, t_scaled, c_eps, reject


def test_index_form_equals_one_hot_on_finite_rows():
    """The kernels' index-picked shear gives the one-hot form's edge
    functions, det, scaled t, bound and reject mask on every finite row, up
    to the sign of a zero (assert_array_equal compares -0 == 0 and NaN at the
    same places): rays of zero direction, FLT_MAX and finite t_max."""
    c = case("random")
    o, d, t_max, _ = case_rays(c)
    o3, d3 = tuple(torch.as_tensor(o).unbind(-1)), tuple(torch.as_tensor(d).unbind(-1))
    rc = wt.ray_constants(o3, d3)
    tm = torch.as_tensor(t_max)
    for row in torch.as_tensor(c.table[:c.n_tri]):
        for got, want in zip(index_form_edge_test(rc, row, tm), wt._edge_test(rc, row, tm)):
            np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("bad", [np.inf, -np.inf])
def test_index_form_differs_on_infinite_rows(bad):
    """A row with an infinite vertex coordinate: the one-hot form's
    0 * inf = NaN reaches the edge functions where the index form keeps
    +-inf, so the two forms' tests disagree on some rays; the kernels keep
    the one-hot form for such a row."""
    c = case("random")
    o, d, t_max, _ = case_rays(c)
    o3, d3 = tuple(torch.as_tensor(o).unbind(-1)), tuple(torch.as_tensor(d).unbind(-1))
    rc = wt.ray_constants(o3, d3)
    tm = torch.as_tensor(t_max)
    for col in range(9):
        row = torch.as_tensor(c.table[0, :9]).clone()
        row[col] = bad
        e0, _, det, t_scaled, c_eps, reject = index_form_edge_test(rc, row, tm)
        e0_w, _, det_w, t_scaled_w, c_eps_w, reject_w = wt._edge_test(rc, row, tm)
        idx_hit = ~(reject | (torch.where(det < 0.0, -t_scaled, t_scaled) <= c_eps))
        hot_hit = ~(reject_w | (torch.where(det_w < 0.0, -t_scaled_w, t_scaled_w) <= c_eps_w))
        assert torch.equal(hot_hit, wt.watertight_tri_any(rc, row, tm))
        assert (idx_hit != hot_hit).any(), col
        assert (e0.isnan() != e0_w.isnan()).any() or (det.isnan() != det_w.isnan()).any(), col


def test_wrappers_take_plain_on_cpu():
    """On CPU tensors each wrapper is its plain version and counts nothing."""
    c = case("random")
    args = case_args(c, *case_rays(c)[:3])
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
    """Cylinders reach the intersection; so does the alpha flag (a scene
    whose triangles hold no mask gives the same hits through the recast
    loop); more triangles than the sweeps take need a BVH."""
    b = JaxBuilder()
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    b.add_cylinder(jtr.translate([0, 0, 2]))
    scene = bridge(b.finalize())
    assert scene.quad_kind_mask == 1 << sa.QK_CYLINDER
    z = torch.zeros(4, 3)
    assert not si.scene_intersect(scene, z, z + 1.0, torch.ones(4)).valid.any()
    o, d = torch.tensor([[0.2, 0.2, -1.0]] * 4), torch.tensor([[0.0, 0.0, 1.0]] * 4)
    plain = si.scene_intersect(scene, o, d, torch.full((4,), 10.0))
    scene.has_alpha = True
    masked = si.scene_intersect(scene, o, d, torch.full((4,), 10.0))
    assert plain.valid.all() and all(torch.equal(a, b) for a, b in zip(plain, masked))
    scene.has_alpha, scene.n_tris = False, si.BRUTE_FORCE_MAX_TRIS + 1
    with pytest.raises(NotImplementedError, match="BVH"):
        si.scene_intersect_p(scene, z, z + 1.0, torch.ones(4))


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in CASES if n != "empty"])
def test_sweeps_match_interpreted_tpu_kernels(name, monkeypatch):
    """K3 and K5 plain against the Pallas kernels in interpret mode (which
    take no empty table)."""
    monkeypatch.setenv("RS_PBRT_PALLAS_INTERPRET", "1")
    c = case(name)
    o, d, t_max, _ = case_rays(c)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    args = case_args(c, o, d, t_max)
    got = ik.closest_sweep_plain(*args)
    want = jpin.pallas_intersect_tris(jo, jd, jt, *tpu_table(c))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    fh = ik.full_sweep_plain(*args)
    rec = jpin.pallas_intersect_tris_full(jo, jd, jt, jnp.asarray(c.table), c.n_tri)
    np.testing.assert_array_equal(fh.ids.numpy(), np.stack([np.asarray(rec[k]) for k in
                                                            ("prim", "mat", "light")]))
    want_rows = np.concatenate([np.asarray(rec["t"])[None]] + [
        np.asarray(rec[k]).T for k in ("p", "p_err", "ng", "ns", "uv", "dpdu")])
    np.testing.assert_allclose(fh.rows.numpy(), want_rows, rtol=1e-4, atol=1e-4)
