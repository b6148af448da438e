"""The port's BVH (host builder csrc/lbvh.cpp, traversal ops/bvh.py) against
the JAX package's, on the statue at subdivisions=5 (20,484 triangles, above
the brute-force limit) and 4,096 rays: 1,024 camera rays and 3,072 random
rays from a numpy seed, with dead lanes (t_max = -1), unlimited ones
(t_max = FLT_MAX), finite ones, and shadow rays toward the light, 8 of them
of zero direction.

Tolerances: valid and tri equal wherever the two sides walk the same tree
in the same order.  t, b0 and b1 are bit-equal to the JAX traversal run
without FMA contraction (a subprocess with XLA_FLAGS=--xla_cpu_max_isa=SSE4_2);
in this process XLA's CPU compiler contracts the edge functions'
a*b - c*d into fused multiply-adds, which the port (and its kernel, built
with --fmad=false) does not, so there they agree to rtol 2e-4 (the
cancelling edge functions of grazing hits) and atol 1e-5 for the
barycentrics near 0.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import bvh as jbvh
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene import bigscene as jbig
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import bvh
from rs_pbrt_tpu_torch.ops import bvh_native
from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import bigscene
from rs_pbrt_tpu_torch.tools import bvh_ties

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SUBDIV, N_RAYS = 5, 4096
ZERO_DIR = slice(3072, 3080)  # the shadow rays of zero direction
FLT_MAX = np.finfo(np.float32).max


def make_rays(camera, seed=0):
    """(o, d, t_max) numpy f32: camera rays of a 32x32 image, then random
    rays around the statue and shadow rays from the ground toward the light."""
    _, rays = rdr.camera_rays(camera, smpl.make_sampler(smpl.SOBOL, 1, (32, 32)), 0, 1)
    o_cam, d_cam = rays.o.numpy(), rays.d.numpy()
    rng = np.random.default_rng(seed)
    n_rand, n_shadow = 2048, N_RAYS - 1024 - 2048
    o_r = rng.uniform([-2.5, 0.0, -2.5], [2.5, 3.0, 2.5], (n_rand, 3))
    d_r = rng.normal(size=(n_rand, 3))
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o_s = np.stack([rng.uniform(-3, 3, n_shadow), np.full(n_shadow, 1e-3),
                    rng.uniform(-3, 3, n_shadow)], -1)
    target = np.stack([rng.uniform(-1.2, 1.2, n_shadow), np.full(n_shadow, 5.0),
                       rng.uniform(-1.2, 1.2, n_shadow)], -1)
    dist = np.linalg.norm(target - o_s, axis=1)
    d_s = (target - o_s) / dist[:, None]
    d_s[:8] = 0.0  # shadow rays of zero length
    o = np.concatenate([o_cam, o_r, o_s]).astype(np.float32)
    d = np.concatenate([d_cam, d_r, d_s]).astype(np.float32)
    t_max = np.full(N_RAYS, FLT_MAX, np.float32)
    t_rand = t_max[1024:1024 + n_rand]
    kind = rng.uniform(size=n_rand)
    t_rand[kind < 0.25] = rng.uniform(0.1, 4.0, (kind < 0.25).sum())
    t_rand[kind > 0.85] = -1.0  # dead lanes
    t_max[1024 + n_rand:] = dist * (1.0 - 1e-3)
    return o, d, t_max


@pytest.fixture(scope="module")
def statue():
    """The JAX scene and its wide12 rows and depth, the port's scene and
    camera, and the rays."""
    jscene, _ = jbig.statue_scene((32, 32), subdivisions=SUBDIV)
    tree = jsi.build_accel(jscene, lean=True).tri
    scene, camera = bigscene.statue_scene((32, 32), SUBDIV, device="cpu")
    return dict(jscene=jscene, rows=np.asarray(tree.wide128), depth=tree.wide128_dflag.shape[0],
                scene=scene, rays=make_rays(camera))


def port_hit(rows, depth, rays, any_hit, work=None):
    o, d, t_max = (torch.as_tensor(a) for a in rays)
    return bvh.bvh12_intersect_plain(o, d, t_max, torch.as_tensor(rows), depth, any_hit, work)


def test_statue_scene_matches_jax():
    """The port's statue gives the JAX scene's vertices and tables."""
    from test_torch_scene import assert_tables_equal

    jscene, _ = jbig.statue_scene((32, 32), subdivisions=3)
    scene, _ = bigscene.statue_scene((32, 32), 3, device="cpu")
    assert scene.n_tris == 20 * 4 ** 3 + 4
    assert_tables_equal(scene, jscene)
    np.testing.assert_array_equal(scene.tri_attr[:, :9].numpy(),
                                  np.asarray(jscene.tri_attr)[:, :9])


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_matches_jax_traversal(statue, any_hit):
    """(a) bvh12_intersect_plain on the JAX package's rows (through
    accel_from_numpy) against rs_pbrt_tpu.ops.bvh.bvh12_intersect_tris."""
    acc = si.accel_from_numpy(statue["rows"], statue["depth"], device="cpu")
    o, d, t_max = statue["rays"]
    want = jbvh.bvh12_intersect_tris(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                     jnp.asarray(statue["rows"]), statue["depth"], any_hit=any_hit)
    got = port_hit(acc.tri, acc.tri_depth, statue["rays"], any_hit)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    assert 0.2 < got.valid.numpy().mean() < 0.8
    for k in ("t", "b0", "b1"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    # a dead lane and a zero-direction ray are misses, as in JAX
    assert not got.valid[t_max < 0].any() and not got.valid[ZERO_DIR].any()


_JAX_NO_FMA = r"""
import json, sys
import numpy as np, jax.numpy as jnp
from rs_pbrt_tpu.ops import bvh as jbvh
a = np.load(sys.argv[1])
out = {}
for any_hit in (False, True):
    h = jbvh.bvh12_intersect_tris(jnp.asarray(a["o"]), jnp.asarray(a["d"]), jnp.asarray(a["t"]),
                                  jnp.asarray(a["rows"]), int(a["depth"]), any_hit=any_hit)
    for k in ("valid", "tri", "t", "b0", "b1"):
        out[f"{int(any_hit)}_{k}"] = np.asarray(getattr(h, k))
np.savez(sys.argv[2], **out)
"""


def test_plain_bit_equal_to_jax_without_fma(statue, tmp_path):
    """(a) The same comparison against the JAX traversal compiled without
    FMA contraction: every output bit-equal, closest and any hit."""
    want = run_jax_without_fma(tmp_path, *statue["rays"], statue["rows"], statue["depth"])
    for any_hit in (False, True):
        got = port_hit(statue["rows"], statue["depth"], statue["rays"], any_hit)
        for k in ("valid", "tri", "t", "b0", "b1"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), want[f"{int(any_hit)}_{k}"],
                                          err_msg=f"any_hit={any_hit} {k}")


def run_jax_without_fma(tmp_path, o, d, t_max, rows, depth):
    """The JAX traversal, closest and any hit, compiled without FMA
    contraction (a subprocess): {"<any_hit>_<field>": array}."""
    np.savez(tmp_path / "in.npz", o=o, d=d, t=t_max, rows=rows, depth=depth)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", _JAX_NO_FMA, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], env=env, check=True, timeout=300, cwd=ROOT)
    return np.load(tmp_path / "out.npz")


def test_plain_tie_case_bit_equal_to_jax_without_fma(tmp_path):
    """(a) The hand-built tie and NaN tree of tools/bvh_ties: every output of
    the plain traversal bit-equal to the JAX traversal without FMA
    contraction, closest and any hit."""
    o, d, t_max, rows, depth = bvh_ties.tie_case(device="cpu")
    want = run_jax_without_fma(tmp_path, o.numpy(), d.numpy(), t_max.numpy(), rows.numpy(), depth)
    for any_hit in (False, True):
        got = bvh.bvh12_intersect_plain(o, d, t_max, rows, depth, any_hit)
        for k in ("valid", "tri", "t", "b0", "b1"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), want[f"{int(any_hit)}_{k}"],
                                          err_msg=f"any_hit={any_hit} {k}")


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_keeps_tie_rules(any_hit):
    """The rules a traversal must keep, pinned on the tie and NaN tree of
    tools/bvh_ties against the JAX traversal in this process (valid and tri
    equal; t, b0, b1 within 1 ulp-scale tolerance, as XLA contracts FMAs
    here): the lowest of two child slots at equal entry distance is
    entered first, the lowest of two leaf slots at equal t wins, a later
    leaf at equal t does not replace the hit, a NaN t blocks its leaf's
    update, and a ray with t_max < 0 misses with t = t_max."""
    o, d, t_max, rows, depth = bvh_ties.tie_case(device="cpu")
    want = jbvh.bvh12_intersect_tris(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                     jnp.asarray(t_max.numpy()), jnp.asarray(rows.numpy()),
                                     depth, any_hit=any_hit)
    work = {}
    got = bvh.bvh12_intersect_plain(o, d, t_max, rows, depth, any_hit, work)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    for k in ("t", "b0", "b1"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert work["overflow"] == 0
    tri, t = got.tri.numpy(), got.t.numpy()
    x, tm = o[:, 0].numpy(), t_max.numpy()
    axis = np.arange(len(tri)) < 32  # the rays along +z
    dead = tm < 0
    assert dead.sum() == 8 and (tri[dead] == -1).all() and (t[dead] == tm[dead]).all()
    short = axis & (tm > 0) & (tm < 1.0)
    assert short.sum() == 8 and (tri[short] == -1).all() and (t[short] == tm[short]).all()
    region_a, region_b = axis & (x < 1.0) & (tm > 1.0), axis & (x > 2.0) & (tm > 1.0)
    assert region_a.sum() >= 4 and region_b.sum() >= 4
    # B1 finds slot 3's triangle (53); B2 stops at its first hit, which the
    # same walk order makes the same triangle
    assert (tri[region_a] == 53).all() and (t[region_a] == 1.0).all()
    far = region_b & (tm > 3.5)
    assert far.sum() >= 2 and (tri[far] == 70).all()  # the NaN leaf's triangle 31 is blocked
    assert (tri[region_b & (tm < 3.0)] == -1).all()


def ties(hit_a, hit_b):
    """Lanes where two closest-hit results name different triangles."""
    return np.nonzero(hit_a.tri.numpy() != hit_b.tri.numpy())[0]


def test_port_builder_against_jax_builder(statue):
    """(b) The port's builder and the JAX builder on the same triangles,
    compared on what their trees return: the same valid and, but at
    equal-t ties, the same triangle.  (The rows need not be equal: the
    JAX package's committed library was built with -march=native.)"""
    acc = si.build_accel(statue["scene"], device="cpu")
    assert acc.tri.shape[1] == bvh.W12_COLS and acc.tri_depth >= 2
    for any_hit in (False, True):
        ours = port_hit(acc.tri, acc.tri_depth, statue["rays"], any_hit)
        theirs = port_hit(statue["rows"], statue["depth"], statue["rays"], any_hit)
        np.testing.assert_array_equal(ours.valid.numpy(), theirs.valid.numpy())
        if any_hit:
            continue
        tie = ties(ours, theirs)
        np.testing.assert_array_equal(ours.t.numpy()[tie], theirs.t.numpy()[tie])
        assert len(tie) <= 4, f"tied lanes {tie.tolist()}"


def wide_tree(rows):
    """(parent boxes of each row as (lo, hi), depth of each row) by a walk
    from the root."""
    box = {0: None}
    depth = {0: 1}
    stack = [0]
    while stack:
        r = stack.pop()
        row = rows[r]
        if row[bvh._W12_FLAG] > 0.5:
            continue
        base, cnt = int(row[bvh._W12_BASE]), int(row[bvh._W12_COUNT])
        for k in range(cnt):
            lo = row[[k, 12 + k, 24 + k]]
            hi = row[[36 + k, 48 + k, 60 + k]]
            box[base + k] = (lo, hi)
            depth[base + k] = depth[r] + 1
            stack.append(base + k)
    return box, depth


def test_port_rows_structure(statue):
    """(c) Every triangle sits in exactly one leaf slot; every child box
    holds its row's boxes or triangles; the depth is the deepest row and
    its stack fits the kernels' MAX_STACK; no traversal of the rays
    overflows the stack."""
    scene = statue["scene"]
    acc = si.build_accel(scene, device="cpu")
    rows = acc.tri.numpy()
    box, depth = wide_tree(rows)
    assert sorted(box) == list(range(len(rows)))  # every row reached once
    assert max(depth.values()) == acc.tri_depth
    assert bvh.stack_size(acc.tri_depth) <= bvh.MAX_STACK
    leaf = rows[:, bvh._W12_FLAG] > 0.5
    prims = []
    verts = scene.tri_attr[:, :9].numpy()
    for r in np.nonzero(leaf)[0]:
        k = int(rows[r, 120])
        ids = rows[r, bvh._W12_PRIM:bvh._W12_PRIM + k].astype(np.int64)
        prims.extend(ids.tolist())
        np.testing.assert_array_equal(rows[r, :108].reshape(9, 12)[:, :k].T, verts[ids])
        pts = verts[ids].reshape(-1, 3)
        if box[r] is not None:
            lo, hi = box[r]
            assert (pts >= lo - 1e-6).all() and (pts <= hi + 1e-6).all()
    assert sorted(prims) == list(range(scene.n_tris))
    for r in np.nonzero(~leaf)[0]:
        if box[r] is None:
            continue
        lo, hi = box[r]
        cnt = int(rows[r, bvh._W12_COUNT])
        assert (rows[r, 0:36].reshape(3, 12)[:, :cnt].T >= lo - 1e-6).all()
        assert (rows[r, 36:72].reshape(3, 12)[:, :cnt].T <= hi + 1e-6).all()
    for any_hit in (False, True):
        work = {}
        port_hit(acc.tri, acc.tri_depth, statue["rays"], any_hit, work)
        assert work["overflow"] == 0 and work["rows"] <= len(rows)
        assert int(work["leaf"].sum()) > 0 and int(work["internal"].sum()) > 0


def test_single_triangle_tree():
    """The n == 1 guard: one leaf row holding the triangle (its empty slots
    repeat it), depth 0, and a traversal that finds it."""
    p = [np.array([[0.0, 0.0, 1.0]], np.float32), np.array([[1.0, 0.0, 1.0]], np.float32),
         np.array([[0.0, 1.0, 1.0]], np.float32)]
    rows, depth = bvh_native.build_lbvh_native(np.minimum(np.minimum(*p[:2]), p[2]),
                                               np.maximum(np.maximum(*p[:2]), p[2]), p)
    assert rows.shape == (1, 128) and depth == 0 and rows[0, bvh._W12_FLAG] == 1.0
    o = torch.tensor([[0.2, 0.2, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    hit = bvh.bvh12_intersect_plain(o, d, torch.tensor([10.0]), torch.as_tensor(rows), depth)
    assert hit.valid.item() and hit.tri.item() == 0 and hit.t.item() == pytest.approx(1.0)


def test_dense_sweep_against_bvh(statue):
    """(d) The dense K3 plain sweep over the whole table against the BVH
    on 1,024 of the rays (camera and random): the same valid and t, the
    same triangle but at equal-t ties."""
    scene = statue["scene"]
    o, d, t_max = (torch.as_tensor(a[512:1536]) for a in statue["rays"])
    dense = ik.closest_sweep_plain(o, d, t_max, scene.tri_attr, scene.n_tris)
    tree = bvh.bvh12_intersect_plain(o, d, t_max, torch.as_tensor(statue["rows"]),
                                     statue["depth"])
    np.testing.assert_array_equal(tree.valid.numpy(), dense.valid.numpy())
    np.testing.assert_allclose(tree.t.numpy(), dense.t.numpy(), rtol=2e-5)
    tie = ties(tree, dense)
    np.testing.assert_allclose(tree.t.numpy()[tie], dense.t.numpy()[tie], rtol=2e-5)
    assert len(tie) <= 4, f"tied lanes {tie.tolist()}"


def test_wrapper_takes_plain_on_cpu(statue):
    acc = si.accel_from_numpy(statue["rows"], statue["depth"], device="cpu")
    o, d, t_max = (torch.as_tensor(a[:256]) for a in statue["rays"])
    before = dict(bvh.launches)
    hit = bvh.bvh12_intersect_tris(o, d, t_max, acc.tri, acc.tri_depth)
    occ = bvh.bvh12_intersect_tris(o, d, t_max, acc.tri, acc.tri_depth, any_hit=True)
    plain = bvh.bvh12_intersect_plain(o, d, t_max, acc.tri, acc.tri_depth)
    assert torch.equal(hit.tri, plain.tri) and torch.equal(occ, hit.valid)
    assert bvh.launches == before


def test_accel_rules(statue):
    """No tree at or below the brute-force limit; above it, scene
    intersection needs the tree; an unknown accelerator raises (the
    kd-tree builds, tests/test_torch_kdtree.py)."""
    from rs_pbrt_tpu_torch.scene import presets

    small, _ = presets.cornell_box((8, 8), device="cpu")
    assert si.build_accel(small, device="cpu") == si.Accel()
    scene = statue["scene"]
    o, d, t_max = (torch.as_tensor(a[:64]) for a in statue["rays"])
    with pytest.raises(NotImplementedError, match="build_accel"):
        si.scene_intersect(scene, o, d, t_max)
    with pytest.raises(ValueError, match="'bvh', 'kdtree'"):
        si.build_accel(scene, kind="octree", device="cpu")
    it = si.scene_intersect(scene, o, d, t_max, si.accel_from_numpy(statue["rows"],
                                                                    statue["depth"], "cpu"))
    assert it.valid.any() and (it.prim[it.valid] < scene.n_tris).all()
