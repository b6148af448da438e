"""rs_pbrt_tpu_torch's kd-tree (ops/kdtree.py, the D1/D2 wrapper
ops/kdtree_kernel.py, build_accel(kind="kdtree")) against the JAX
package's.

- The host build on the boxes of tests/test_kdtree.py's random triangles,
  on a 5,120-triangle icosphere and on the kd statue (through
  build_accel): every node array exactly equal.
- The walk, closest and any hit, on 300 random triangles and on a
  hand-built chain of 70 interior nodes whose walk overflows the 64-entry
  stack: valid and tri equal, t, b0 and b1 bit-equal to the JAX walk run
  without FMA contraction (a subprocess, tests/_a25scene.py).
- Its closest t equal to the port's BVH traversal's at rtol 1e-6 on the
  statue (subdivisions 4, 5,124 triangles), where the two trees visit the
  triangles in other orders.
- The statue rendered with accelerator="kdtree" (path, depth 5), per
  pixel within 2e-3 of the JAX render, which walks the port's tree (held
  equal to the JAX build above), so the statue is built once on each side
  and the JAX render compiles beside the builds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _a25scene import KD_SUBDIV, RES, JaxJobs
from rs_pbrt_tpu.ops import kdtree as jkd
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene import bigscene as jbig
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import bvh
from rs_pbrt_tpu_torch.ops import kdtree as kd
from rs_pbrt_tpu_torch.ops import kdtree_kernel as kdk
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import bigscene

torch.set_num_threads(2)

FLT_MAX = np.finfo(np.float32).max
CHAIN = 70  # interior nodes of the hand-built tree, past the stack's 64
KD_FIELDS = ("axis", "split", "above", "start", "count", "prim_ids", "bmin", "bmax")


def random_tris(n, seed=0, spread=4.0):
    """tests/test_kdtree.py's _random_tris: (p0, p1, p2) f32."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    return c, c + e1, c + e2


def random_rays(m, seed=1, spread=6.0, aim=None):
    """tests/test_kdtree.py's _random_rays, the last half aimed at points
    of aim (K, 3) where given, then a quarter dead (t_max -1) and a
    quarter of limited length."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    if aim is not None:
        d[m // 2:] = aim[rng.integers(0, len(aim), m - m // 2)] - o[m // 2:]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.full(m, FLT_MAX, np.float32)
    t[: m // 4] = -1.0
    t[m // 4: m // 2] = rng.uniform(0.5, 8.0, m // 4)
    return o, d, t


def boxes(p0, p1, p2):
    return np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2)


def icosphere_boxes():
    """The boxes of the 5,120 triangles of a unit icosphere(4)."""
    v, f = bigscene.icosphere(4)
    v = v.astype(np.float32)
    return boxes(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])


def chain_tree():
    """A kd-tree of CHAIN interior nodes along x (split CHAIN - i, the
    below child next, an empty leaf above) ending in a leaf of one
    triangle at x = 0.5, and a ray from x = 0.1 along +x: every level
    visits both children, so the walk pushes CHAIN far leaves and
    overflows its stack.  -> (arrays as build_kdtree's, tris (1, 9), o, d)."""
    n_int = CHAIN
    axis = np.r_[np.zeros(n_int), [3] * (n_int + 1)].astype(np.int32)
    split = np.r_[n_int - np.arange(n_int, dtype=np.float32), np.zeros(n_int + 1)]
    above = np.r_[n_int + 1 + np.arange(n_int), np.zeros(n_int + 1)].astype(np.int32)
    count = np.zeros(2 * n_int + 1, np.int32)
    count[n_int] = 1
    arrays = dict(axis=axis, split=split.astype(np.float32), above=above,
                  start=np.zeros(2 * n_int + 1, np.int32), count=count,
                  prim_ids=np.zeros(1, np.int32), bmin=np.array([0, -1, -1], np.float32),
                  bmax=np.array([n_int + 1, 2, 2], np.float32), leaf_cap=1)
    tris = np.array([[0.5, -1, -1, 0.5, 2, -1, 0.5, -1, 2]], np.float32)
    o = np.array([[0.1, 0.0, 0.0], [0.1, 0.3, 0.2]], np.float32)
    d = np.array([[1.0, 0.001, 0.002], [1.0, -0.01, 0.0]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return arrays, tris, o, d


def tree_arrays(kt: kd.KdTree) -> dict:
    """build_kdtree's arrays of the port's KdTree."""
    out = {k: getattr(kt, k).cpu().numpy() for k in KD_FIELDS[:6]}
    world = kt.world.cpu().numpy()
    return dict(out, bmin=world[:3], bmax=world[3:], leaf_cap=kt.leaf_cap)


@pytest.fixture(scope="module")
def statue():
    scene, camera = bigscene.statue_scene((RES, RES), KD_SUBDIV, device="cpu")
    return dict(scene=scene, camera=camera, kd=si.build_accel(scene, kind="kdtree", device="cpu"))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory, request):
    """Two subprocesses: the icosphere's build and the walks; the kd
    statue's render, which walks the port's tree (the statue case of
    test_build_matches_jax holds it equal to the JAX build), started once
    that tree is built."""
    p = random_tris(300)
    o, d, t = random_rays(512, aim=(p[0] + p[1] + p[2]) / 3)
    arrays, ctris, co, cd = chain_tree()
    walks = {"rand:tris": np.concatenate(p, 1), "rand:o": o, "rand:d": d, "rand:t_max": t,
             "chain:tris": ctris, "chain:o": co, "chain:d": cd,
             "chain:t_max": np.full(2, FLT_MAX, np.float32),
             **{"chain:kd_" + k: arrays[k] for k in KD_FIELDS},
             "chain:kd_leaf_cap": np.int32(1)}
    lo, hi = icosphere_boxes()
    jax = JaxJobs(tmp_path_factory.mktemp("kd"))
    jax.start({"ico": ("kd_build", {}), "rand": ("kd_walk", {}), "chain": ("kd_walk", {})},
              dict(walks, **{"ico:bmin": lo, "ico:bmax": hi}))
    tree = tree_arrays(request.getfixturevalue("statue")["kd"].kd)
    jax.start({"render": ("render", dict(scene="kd", cfg=("path", 2, 5, None, "kdtree")))},
              {"render:kd_" + k: np.asarray(v) for k, v in tree.items()})
    yield jax
    jax.close()


BUILD_CASES = {"random200": (200, 0), "random300": (300, 0), "random150": (150, 3),
               "random100": (100, 5), "icosphere": None, "statue": None}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_matches_jax(case, jax_side, statue):
    """build_kdtree's node arrays and leaf cap, exactly the JAX build's: the
    statue's through either package's build_accel(kind="kdtree"), the
    icosphere's JAX build in a subprocess, the others here (host numpy, no
    XLA).  jax_side starts the subprocesses first, so they run beside these
    builds."""
    if case == "statue":
        got = tree_arrays(statue["kd"].kd)
        scene, _ = jbig.statue_scene((RES, RES), subdivisions=KD_SUBDIV)
        jt = jsi.build_accel(scene, kind="kdtree").tri
        want = dict(jt._asdict(), leaf_cap=jt.leaf_cap.shape[0])
    elif case == "icosphere":
        lo, hi = icosphere_boxes()
        assert len(lo) == 5120
        got = kd.build_kdtree(lo, hi)
        res = jax_side.results("ico")
        want = {k: res["ico:" + k] for k in KD_FIELDS + ("leaf_cap",)}
    else:
        lo, hi = boxes(*random_tris(*BUILD_CASES[case]))
        got = kd.build_kdtree(lo, hi)
        jt = jkd.build_kdtree(lo, hi)
        want = dict(jt._asdict(), leaf_cap=jt.leaf_cap.shape[0])
    for k in KD_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["leaf_cap"] == int(want["leaf_cap"])
    assert (got["axis"] == kd.LEAF).any() and (got["axis"] < kd.LEAF).any()


def test_walk_matches_jax(jax_side):
    """Closest and any hit over 300 random triangles, bit-equal."""
    res = jax_side.results("rand")
    p = random_tris(300)
    tris = torch.as_tensor(np.concatenate(p, 1))
    kt = kd.kdtree_from_numpy(kd.build_kdtree(*boxes(*p)), "cpu")
    o, d, t = (torch.as_tensor(a) for a in random_rays(512, aim=(p[0] + p[1] + p[2]) / 3))
    h = kdk.kd_intersect(o, d, t, kt, tris)  # the plain walk on the CPU
    assert 0.1 < float(h.valid.float().mean()) < 0.9
    for k in ("valid", "tri", "t", "b0", "b1"):
        np.testing.assert_array_equal(getattr(h, k).numpy(), res["rand:" + k], err_msg=k)
    occ = kdk.kd_intersect(o, d, t, kt, tris, any_hit=True)
    np.testing.assert_array_equal(occ.numpy(), res["rand:any_valid"])
    np.testing.assert_array_equal(occ.numpy(), h.valid.numpy())
    a = kd.kdtree_intersect_plain(o, d, t, kt, tris, any_hit=True)
    np.testing.assert_array_equal(a.t.numpy(), res["rand:any_t"])


def test_stack_overflow_matches_jax(jax_side):
    """A push onto the full stack overwrites its top with the far child,
    as the JAX loop's clamped slot does: the near chain is lost, so the
    triangle at its end is missed, by both walks, and counted."""
    res = jax_side.results("chain")
    arrays, tris, o, d = chain_tree()
    kt = kd.kdtree_from_numpy(arrays, "cpu")
    w = {}
    h = kd.kdtree_intersect_plain(torch.as_tensor(o), torch.as_tensor(d),
                                  torch.full((2,), float(FLT_MAX)), kt, torch.as_tensor(tris),
                                  work=w)
    np.testing.assert_array_equal(h.valid.numpy(), res["chain:valid"])
    np.testing.assert_array_equal(h.t.numpy(), res["chain:t"])
    # one push a ray finds the stack full; its near chain is lost there
    assert not h.valid.any() and w["overflow"] == 2
    assert (w["nodes"] > CHAIN).all()


def test_closest_t_matches_bvh(statue):
    """The kd walk's closest t equals the port's BVH traversal's (rtol
    1e-6) on the statue's camera rays and random rays around it."""
    scene = statue["scene"]
    acc_b = si.build_accel(scene, device="cpu")
    _, rays = rdr.camera_rays(statue["camera"], smpl.make_sampler(smpl.SOBOL, 1, (RES, RES)), 0, 1)
    rng = np.random.default_rng(3)
    o = torch.cat([rays.o, torch.as_tensor(rng.uniform([-2, 0, -2], [2, 3, 2], (512, 3)),
                                           dtype=torch.float32)])
    dr = rng.normal(size=(512, 3))
    d = torch.cat([rays.d, torch.as_tensor(dr / np.linalg.norm(dr, axis=1, keepdims=True),
                                           dtype=torch.float32)])
    t = torch.full((o.shape[0],), float(FLT_MAX))
    w = {}
    hk = kd.kdtree_intersect_plain(o, d, t, statue["kd"].kd, statue["kd"].kd_tris, work=w)
    hb = bvh.bvh12_intersect_plain(o, d, t, acc_b.tri, acc_b.tri_depth)
    np.testing.assert_array_equal(hk.valid.numpy(), hb.valid.numpy())
    np.testing.assert_allclose(hk.t.numpy(), hb.t.numpy(), rtol=1e-6)
    assert w["overflow"] == 0 and float(hk.valid.float().mean()) > 0.5


def test_accel_kinds(statue):
    scene = statue["scene"]
    acc = statue["kd"]
    assert acc.tri is None and acc.kd is not None and si.uses_kd(scene, acc)
    assert not si.uses_bvh(scene, acc) and si.uses_tree(scene, acc)
    assert acc.kd_tris.shape == (scene.n_tris, 9) and acc.kd.leaf_cap >= 1
    with pytest.raises(ValueError, match="octree"):
        si.build_accel(scene, kind="octree", device="cpu")
    rdr.check_cfg(rdr.RenderCfg("path", 1, 5, 1.0, accelerator="kdtree"))
    with pytest.raises(ValueError, match="octree"):
        rdr.check_cfg(rdr.RenderCfg("path", 1, 5, 1.0, accelerator="octree"))
    o = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="expected CUDA"):
        kdk._check("o", o, torch.float32, (2, 3))
    before = dict(kdk.launches)
    kdk.kd_intersect(o, torch.ones(2, 3), torch.ones(2), acc.kd, acc.kd_tris, any_hit=True)
    assert kdk.launches == before


def test_render_matches_jax(jax_side, statue):
    """The statue with accelerator="kdtree": path, 2 spp, depth 5, per pixel
    within 2e-3 of the JAX render, and the same image as through the BVH."""
    cfg = rdr.RenderCfg("path", 2, 5, 1.0, accelerator="kdtree")
    scfg = smpl.make_sampler(smpl.SOBOL, 2, (RES, RES))
    img = rdr.render(statue["scene"], statue["camera"], cfg, scfg, accel=statue["kd"]).numpy()
    want = jax_side.results("render")["render:img"]
    assert np.isfinite(img).all() and want.mean() > 0.02
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)
