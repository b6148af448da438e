"""rs_pbrt_tpu_torch's curves (ops/curves.py, the binary tree of
ops/bvh_native.py, scene intersection with curves) against the JAX
package's on the same numpy inputs.

The CUDA kernels C1-C4 (csrc/curves.cu) run only on the card; here their
wrappers run the plain versions, which chip_smoke.py holds the kernels to.

Tolerances: the flattened segments and their rows bit-equal (the same
numpy code); the port's curve tree's arrays equal to the JAX build_accel's.
The leaf test against the JAX one (compiled without FMA contraction) on
20,000 random (ray, segment) pairs: the hit decisions equal but for at
most 0.1% of the pairs (a test decided within rounding of a reject
boundary), t, u, v and w within rtol 1e-4, atol 1e-6 where both hit but
for at most 0.1% of those pairs, which hold within atol 1e-5 (an
ill-conditioned closest approach: on the one such pair of this input both
packages lie ~1.3e-6 from the float64 value of v, on either side).  The walk and the sweep against the JAX ones:
valid and seg equal, t rtol 1e-5 (the pattern of
tests/test_curves_hair.py:79-112).  The plain sweep equal to the plain
walk.  Scene intersection: valid, prim and mat equal, t, p rtol 1e-5,
the normals atol 1e-4.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import curves as jcv
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.ops import bvh_native
from rs_pbrt_tpu_torch.ops import curve_kernel as ck
from rs_pbrt_tpu_torch.ops import curves as cv
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import curve_cases
from test_torch_scene import bridge

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
T = lambda a: torch.as_tensor(np.asarray(a))
J = lambda a: jnp.asarray(np.asarray(a))


def random_curves(rng, n, ctype, normals=False):
    """n random curves near the origin: control points, widths and ribbon
    normals."""
    p0 = rng.uniform(-1.5, 1.5, (n, 3))
    cps = np.stack([p0, p0 + rng.normal(0, 0.4, (n, 3)), p0 + rng.normal(0, 0.4, (n, 3)),
                    p0 + rng.normal(0, 0.8, (n, 3))], 1).astype(np.float32)
    w0 = rng.uniform(0.05, 0.3, n).astype(np.float32)
    w1 = rng.uniform(0.01, 0.2, n).astype(np.float32)
    nn = None
    if normals:
        nn = rng.normal(size=(n, 2, 3)).astype(np.float32)
        nn /= np.linalg.norm(nn, axis=-1, keepdims=True)
        nn[0, 1] = nn[0, 0]  # one straight ribbon (norm_angle 0)
    return cps, w0, w1, np.full(n, ctype, np.int32), nn


@pytest.mark.parametrize("ctype", [cv.FLAT, cv.CYLINDER, cv.RIBBON])
def test_flatten_and_pack_bit_equal(ctype):
    rng = np.random.default_rng(ctype)
    cps, w0, w1, types, nn = random_curves(rng, 12, ctype, normals=ctype == cv.RIBBON)
    n0, n1 = (None, None) if nn is None else (nn[:, 0], nn[:, 1])
    for split in (0, 2):
        got = cv.flatten_curves(cps, w0, w1, types, n0, n1, splitdepth=split)
        want = jcv.flatten_curves(cps, w0, w1, types, n0, n1, splitdepth=split)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        mats = np.arange(got["crv_cp"].shape[0]) % 3
        np.testing.assert_array_equal(cv.pack_curve_attr(got, mats),
                                      jcv.pack_curve_attr(want, mats))
    np.testing.assert_array_equal(cv.adaptive_depth_np(cps, w0, w1),
                                  jcv.adaptive_depth_np(cps, w0, w1))


_JAX_SEG_TEST = r"""
import sys
import numpy as np, jax.numpy as jnp
from rs_pbrt_tpu.ops import curves as jcv
a = np.load(sys.argv[1])
s = jcv._gather_seg(jnp.asarray(a["rows"]))
h = jcv.curve_seg_test(jnp.asarray(a["o"]), jnp.asarray(a["d"]), jnp.asarray(a["t"]), s["cp"],
                       s["w0"], s["w1"], s["u0"], s["u1"], s["n0"], s["n1"], s["norm_angle"],
                       s["inv_sin_na"], s["ctype"])
np.savez(sys.argv[2], **{k: np.asarray(getattr(h, k)) for k in ("hit", "t", "u", "v", "w")})
"""


def test_seg_test_matches_jax(tmp_path):
    """The leaf test on 20,000 (ray, segment) pairs, against the JAX one
    compiled without FMA contraction (a subprocess with
    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2, as tests/test_torch_bvh.py runs
    the traversal): v near a fibre's axis is 0.5 +- sqrt(dist2) / width,
    and with contracted products the cancellation in dist2 moves it by up to
    1e-5, past rtol 1e-4."""
    rows = curve_cases.table_rows(1024, seed=5)
    o, d, t_max, seg = (np.asarray(a) for a in curve_cases.rays_at(rows, 20000, seed=5,
                                                                    device="cpu"))
    r = rows[seg]
    np.savez(tmp_path / "in.npz", o=o, d=d, t=t_max, rows=r)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", _JAX_SEG_TEST, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], env=env, check=True, timeout=300, cwd=ROOT)
    want = np.load(tmp_path / "out.npz")
    s = cv._split_rows(T(r))
    got = cv.curve_seg_test(T(o), T(d), T(t_max), T(r[:, :12].reshape(-1, 4, 3)), s["w0"],
                            s["w1"], s["u0"], s["u1"], T(r[:, 16:19]), T(r[:, 19:22]),
                            s["norm_angle"], s["inv_sin_na"], T(r[:, 24].astype(np.int32)))
    hit, jhit = got.hit.numpy(), want["hit"]
    try:
        differ = int((hit != jhit).sum())
        assert jhit.sum() > 2000 and differ <= 0.001 * hit.size, (int(jhit.sum()), differ)
        both = hit & jhit
        for k in ("t", "u", "v", "w"):
            a, b = getattr(got, k).numpy()[both], want[k][both]
            # an ill-conditioned closest approach (w from a near-degenerate
            # chord) moves w, and v with it, by a few 1e-6 in both packages;
            # such pairs, at most 0.1%, hold within 1e-5
            off = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
            assert off.sum() <= 0.001 * both.sum(), (k, int(off.sum()))
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=k)
        # the zero-direction rays hit nothing in either
        assert not hit[:4].any() and not jhit[:4].any()
    except AssertionError as e:
        # keep the port's side beside the JAX side (out.npz) and the inputs
        # (in.npz), so a failure shows which side moved
        np.savez(tmp_path / "port.npz", **{k: getattr(got, k).numpy()
                                            for k in ("hit", "t", "u", "v", "w")})
        raise AssertionError(f"{e}\nthe port's side: {tmp_path / 'port.npz'}, the JAX side: "
                             f"{tmp_path / 'out.npz'}, the inputs: {tmp_path / 'in.npz'}") from e


def _curve_scene(builder_cls, n_fibers, rng_seed=0, ctype="cylinder"):
    """A floor of two triangles under n_fibers fibres (the fur patch's
    shape at small size)."""
    b = builder_cls()
    hair = b.add_hair(sigma_a=(0.06, 0.1, 0.2))
    rng = np.random.default_rng(rng_seed)
    x, z = rng.uniform(-0.5, 0.5, n_fibers), rng.uniform(-0.5, 0.5, n_fibers)
    cps = np.stack([np.stack([x, 0 * x, z], -1), np.stack([x + 0.1, 0 * x + 0.33, z], -1),
                    np.stack([x + 0.2, 0 * x + 0.66, z], -1),
                    np.stack([x + 0.4, 0 * x + 1.0, z], -1)], 1).astype(np.float32)
    normals = None
    if ctype == "ribbon":
        normals = np.tile(np.asarray([[[0, 0, 1], [0.6, 0, 0.8]]], np.float32), (n_fibers, 1, 1))
    b.add_curve(cps, width0=0.02, width1=0.008, curve_type=ctype, splitdepth=2, material=hair,
                normals=normals)
    floor = b.add_matte(kd=(0.4, 0.4, 0.45))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        np.asarray([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
                        material=floor)
    b.add_point_light(p=(2, 3, 2), I=(40, 40, 40))
    return b.finalize() if builder_cls is JaxBuilder else b.finalize(device="cpu")


def _fur_rays(n, seed):
    """curve_cases.fur_rays as numpy arrays."""
    return tuple(a.numpy() for a in curve_cases.fur_rays(n, seed, device="cpu"))


@pytest.fixture(scope="module")
def fur():
    """A 64-fibre patch (2,048 segments) in both packages, its trees and rays."""
    jscene = _curve_scene(JaxBuilder, 64)
    scene = _curve_scene(SceneBuilder, 64)
    jacc = jsi.build_accel(jscene)
    acc = si.build_accel(scene, device="cpu")
    rays = _fur_rays(3000, 2)
    return scene, jscene, acc, jacc, rays


def test_curve_tree_equals_jax(fur):
    scene, jscene, acc, jacc, _ = fur
    np.testing.assert_array_equal(scene.crv_attr.numpy(), np.asarray(jscene.crv_attr))
    assert scene.n_curve_segs == 2048 > si.BRUTE_FORCE_MAX_CURVES
    tree = bvh_native.build_binary_native(*cv.segment_boxes(scene.crv_attr.numpy()))
    for k, v in tree.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jacc.crv, k)), err_msg=k)
    np.testing.assert_array_equal(acc.crv.child.numpy(),
                                  np.stack([tree["child_l"], tree["child_r"]], -1))
    np.testing.assert_array_equal(acc.crv.prim.numpy(), tree["prim_ids"])
    # one segment: the JAX build_lbvh's node with the leaf on both sides
    one = bvh_native.build_binary_native(np.zeros((1, 3)), np.ones((1, 3)))
    assert one["child_l"].tolist() == one["child_r"].tolist() == [-1]
    assert one["prim_ids"].tolist() == [0]


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_matches_jax(fur, any_hit):
    scene, jscene, acc, jacc, (o, d, t_max) = fur
    work = {}
    got = cv.bvh_intersect_curves_plain(T(o), T(d), T(t_max), acc.crv, scene.crv_attr,
                                        any_hit=any_hit, work=work)
    want = jcv.bvh_intersect_curves(J(o), J(d), J(t_max), jacc.crv, jscene.crv_attr,
                                    any_hit=any_hit)
    np.testing.assert_array_equal(got.numpy() if any_hit else got.valid.numpy(),
                                  np.asarray(want.valid))
    assert work["clamped"] == 0 and int(work["nodes"].sum()) > 0
    if any_hit:
        return
    v = got.valid.numpy()
    assert v.sum() > 300
    np.testing.assert_array_equal(got.seg.numpy(), np.asarray(want.seg))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    np.testing.assert_array_equal(got.t.numpy()[~v], t_max[~v])
    # the wrapper runs the plain version for CPU tensors
    again = ck.walk_closest(T(o), T(d), T(t_max), acc.crv, scene.crv_attr)
    np.testing.assert_array_equal(again.seg.numpy(), got.seg.numpy())


def test_sweep_matches_jax_and_walk(fur):
    scene, _, acc, _, (o, d, t_max) = fur
    rows = scene.crv_attr[:1024]  # one sweep's worth
    jrows = J(rows.numpy())
    got = cv.intersect_curves_plain(T(o), T(d), T(t_max), rows)
    want = jcv.intersect_curves_brute(J(o), J(d), J(t_max), jrows)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.seg.numpy(), np.asarray(want.seg))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    any_hit = cv.intersect_curves_plain(T(o), T(d), T(t_max), rows, any_hit=True)
    np.testing.assert_array_equal(any_hit.numpy(), got.valid.numpy())
    # the sweep over every segment equals the walk through the tree
    sweep = ck.sweep_closest(T(o), T(d), T(t_max), scene.crv_attr)
    walk = ck.walk_closest(T(o), T(d), T(t_max), acc.crv, scene.crv_attr)
    np.testing.assert_array_equal(sweep.valid.numpy(), walk.valid.numpy())
    v = sweep.valid.numpy()
    np.testing.assert_array_equal(sweep.seg.numpy()[v], walk.seg.numpy()[v])
    np.testing.assert_array_equal(sweep.t.numpy(), walk.t.numpy())
    np.testing.assert_array_equal(
        ck.sweep_any(T(o), T(d), T(t_max), scene.crv_attr).numpy(),
        ck.walk_any(T(o), T(d), T(t_max), acc.crv, scene.crv_attr).numpy())


def test_walk_stack_clamp_and_dead_rays():
    """A tree whose walk defers more nodes than the stack holds: the plain
    walk clamps as the JAX walk does (the same answers) and counts the
    overwritten pushes; rays with t_max < 0 or NaN hit nothing."""
    from rs_pbrt_tpu.ops.bvh import LBVH

    rows = curve_cases.table_rows(256, seed=9)
    tree, arrays, s = curve_cases.clamp_tree(rows, device="cpu")
    rows = rows[:s]
    # not the rays along a chord (4-7), whose hits at a shared end point
    # XLA's fused multiply-adds may give to the neighbouring segment
    o, d, t_max = (a[8:].numpy().copy() for a in curve_cases.rays_at(rows, 408, seed=9,
                                                                    device="cpu")[:3])
    t_max[:4] = [-1.0, np.nan, -1.0, np.nan]
    work = {}
    got = cv.bvh_intersect_curves_plain(T(o), T(d), T(t_max), tree, T(rows), work=work)
    jt = LBVH(*(J(arrays[k]) for k in ("child_l", "child_r", "bmin_l", "bmax_l", "bmin_r",
                                        "bmax_r", "prim_ids")))
    want = jcv.bvh_intersect_curves(J(o), J(d), J(t_max), jt, J(rows))
    assert work["clamped"] > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.seg.numpy(), np.asarray(want.seg))
    assert not got.valid.numpy()[:4].any()
    np.testing.assert_allclose(got.t.numpy()[~np.isnan(t_max)], np.asarray(want.t)[~np.isnan(t_max)],
                               rtol=1e-5)


@pytest.mark.parametrize("ctype", ["cylinder", "ribbon"])
def test_scene_intersect_with_curves(ctype):
    """The closest hit and the shadow ray on a floor under fibres, through
    the sweep (32 fibres, 1,024 segments) and the walk (48, 1,536)."""
    for n_fibers in (32, 48):
        jscene = _curve_scene(JaxBuilder, n_fibers, 4, ctype)
        scene = bridge(jscene)
        own = _curve_scene(SceneBuilder, n_fibers, 4, ctype)
        np.testing.assert_array_equal(own.crv_attr.numpy(), scene.crv_attr.numpy())
        assert own.world_radius == pytest.approx(float(jscene.world_radius), rel=1e-6)
        jacc = jsi.build_accel(jscene)
        acc = si.build_accel(scene, device="cpu")
        assert (acc.crv is not None) == (n_fibers == 48) == si.uses_curve_bvh(scene, acc)
        o, d, t_max = _fur_rays(1500, n_fibers)
        it = si.scene_intersect(scene, T(o), T(d), T(t_max), acc)
        jit = jsi.scene_intersect(jscene, J(o), J(d), J(t_max), jacc)
        v = np.asarray(jit.valid)
        np.testing.assert_array_equal(it.valid.numpy(), v)
        for k in ("prim", "mat", "light"):
            np.testing.assert_array_equal(getattr(it, k).numpy(), np.asarray(getattr(jit, k)), k)
        crv = v & (np.asarray(jit.prim) >= 2)
        assert crv.sum() > 100 and (v & ~crv).sum() > 100
        np.testing.assert_allclose(it.t.numpy(), np.asarray(jit.t), rtol=1e-5)
        np.testing.assert_allclose(it.p.numpy()[v], np.asarray(jit.p)[v], rtol=1e-5, atol=1e-6)
        for k in ("ng", "ns", "dpdu", "uv", "p_error"):
            np.testing.assert_allclose(getattr(it, k).numpy()[v], np.asarray(getattr(jit, k))[v],
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        occ = si.scene_intersect_p(scene, T(o), T(d), T(np.minimum(t_max, 2.5)), acc)
        jocc = jsi.scene_intersect_p(jscene, J(o), J(d), J(np.minimum(t_max, 2.5)), jacc)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_curves_need_their_tree():
    scene = _curve_scene(SceneBuilder, 48)
    z = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError, match="curve segments need their tree"):
        si.scene_intersect(scene, z, z + 1.0, torch.ones(4))
    assert scene.crv_attr.shape[1] == sa.N_CURVE_ATTR
