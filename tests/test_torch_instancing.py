"""rs_pbrt_tpu_torch's two-level instancing (ops/instancing.py, the I1/I2
wrapper ops/instance_kernel.py, scene_intersect's instance merge) against
the JAX package's, on the forest (tools/instance_scenes.forest_build: 16
instances of a 320-triangle prototype on a 4x4 lattice, each with its
yaw, scale and material override).

The rays: the camera's at 32x32, grazing rays along the lattice's
diagonal (many enter more than K_CANDIDATES = 4 boxes, where the JAX
semantics may drop a hit and the port keeps them), shadow rays toward the
light from points inside overlapping instance boxes (entered at distance
0: a tie the top tree's order breaks), dead lanes (t_max = -1) and rays
of limited length.

Tolerances.  The walk against JAX's, computed without FMA contraction in
one subprocess (tests/_a25scene.py): the candidate lists, valid, inst and
tri equal, t, b0 and b1 bit-equal (the port builds the JAX numpy LBVH for
the top and the prototype trees, so both walk the same trees in the same
order).  The scene_intersect records within rtol = atol = 1e-5 (the
transforms' sums may associate otherwise in XLA), prim, mat and light
equal; the renders per pixel within 2e-3 (the renders' tolerance of
PERF.md section 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _a25scene import FOREST, RES, JaxJobs
from rs_pbrt_tpu.ops import bvh as jbvh
from rs_pbrt_tpu.scene import arrays as jsa
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import regen
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import instance_kernel as ink
from rs_pbrt_tpu_torch.ops import instancing as inst
from rs_pbrt_tpu_torch.ops import path_kernel as pk
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import instance_scenes as isc
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)
# the JAX subprocesses start before the first test, so they compile while
# the tests that need none run
pytestmark = pytest.mark.usefixtures("forest")

FLT_MAX = np.finfo(np.float32).max
RENDERS = {
    # lane width 1,024 of 4,096 paths: every lane is refilled
    "path": (("path", 4, 5, None, "bvh"), dict(lane_width=1024)),
    "directlighting": (("directlighting", 2, 1, None, "bvh"), {}),
}


def forest_rays(camera, seed=0):
    """(o, d, t_max) numpy f32: the 32x32 camera rays, 512 grazing rays
    across the lattice's diagonal, 512 shadow rays from inside the
    instances' boxes toward the light, 256 random rays with dead lanes and
    limited lengths."""
    _, rays = rdr.camera_rays(camera, smpl.make_sampler(smpl.SOBOL, 1, (RES, RES)), 0, 1)
    rng = np.random.default_rng(seed)
    half = isc.forest_extent(FOREST["grid"])
    m = 512
    y0 = rng.uniform(0.2, 1.6, m)
    o_g = np.stack([np.full(m, -half - 2.0), y0, np.full(m, -half - 2.0)], -1)
    o_g[:, [0, 2]] += rng.normal(0, 0.4, (m, 2))
    tgt = np.stack([np.full(m, half + 2.0), y0 + rng.normal(0, 0.2, m), np.full(m, half + 2.0)],
                   -1) + rng.normal(0, 0.4, (m, 3))
    d_g = tgt - o_g
    d_g /= np.linalg.norm(d_g, axis=1, keepdims=True)
    cell = rng.integers(0, FOREST["grid"], (m, 2))
    o_s = np.stack([-half + cell[:, 1] * isc.SPACING, rng.uniform(0.1, 1.8, m),
                    -half + cell[:, 0] * isc.SPACING], -1) + rng.uniform(-1.3, 1.3, (m, 3)) * [1, 0, 1]
    light = np.array([0.0, 3.0 * (half + isc.SPACING), 0.0])
    to = light + rng.uniform(-0.3, 0.3, (m, 3)) * [1, 0, 1] - o_s
    dist = np.linalg.norm(to, axis=1)
    d_s = to / dist[:, None]
    k = 256
    o_r = rng.uniform([-half - 1, 0.1, -half - 1], [half + 1, 3.0, half + 1], (k, 3))
    d_r = rng.normal(size=(k, 3))
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    t_r = np.where(rng.uniform(size=k) < 0.3, -1.0, rng.uniform(0.5, 6.0, k))
    o = np.concatenate([rays.o.numpy(), o_g, o_s, o_r]).astype(np.float32)
    d = np.concatenate([rays.d.numpy(), d_g, d_s, d_r]).astype(np.float32)
    t_max = np.concatenate([np.full(RES * RES + m, FLT_MAX), dist * (1 - 1e-3),
                            t_r]).astype(np.float32)
    return o, d, t_max


@pytest.fixture(scope="module")
def forest(tmp_path_factory):
    scene, camera = isc.forest_scene((RES, RES), **FOREST, device="cpu")
    o, d, t_max = forest_rays(camera)
    # the path render (the longest compile) in one subprocess, the walk
    # and then the directlighting render in the other
    jax = JaxJobs(tmp_path_factory.mktemp("forest"))
    render = {tag: ("render", dict(scene="forest", cfg=cfg, accel=True, **opt))
              for tag, (cfg, opt) in RENDERS.items()}
    jax.start({"path": render["path"]})
    jax.start({"walk": ("forest", {}), "directlighting": render["directlighting"]},
              {"walk:o": o, "walk:d": d, "walk:t_max": t_max})
    yield dict(scene=scene, camera=camera, accel=si.build_accel(scene, device="cpu"),
               rays=tuple(torch.as_tensor(a) for a in (o, d, t_max)), jax=jax)
    jax.close()


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1000])
def test_build_lbvh_matches_jax(n):
    """The port's copy of the JAX numpy LBVH gives its arrays, value for
    value (the top tree decides which of the boxes entered at equal
    distance a ray keeps)."""
    rng = np.random.default_rng(n)
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 2, (n, 3)).astype(np.float32)
    lo[: n // 3] = lo[0]  # coincident boxes: equal Morton codes
    hi[: n // 3] = hi[0]
    got = inst.build_lbvh(lo, hi)
    want = jbvh.build_lbvh(lo, hi)
    for k in ("child_l", "child_r", "bmin_l", "bmax_l", "bmin_r", "bmax_r", "prim_ids"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)


def _instanced_calls(b):
    """The forest's calls plus a prototype from per-triangle lists with
    reversed triangles and an instance that mirrors it."""
    isc.forest_build(b, **FOREST)
    v, f = isc.statue_mesh(0)
    n = len(f)
    tris = dict(p0=[v[f[:, 0]]], p1=[v[f[:, 1]]], p2=[v[f[:, 2]]], n0=[v[f[:, 0]]],
                n1=[v[f[:, 1]]], n2=[v[f[:, 2]]], has_n=[np.ones(n, bool)],
                uv0=[np.zeros((n, 2), np.float32)], uv1=[np.ones((n, 2), np.float32)],
                uv2=[np.ones((n, 2), np.float32)], mat=[np.full(n, 2)],
                reverse=[np.arange(n) % 2 == 0])
    p = b.add_prototype_tris(tris)
    b.add_instance(p, tr.from_matrix(np.diag([-1.0, 1.0, 1.0, 1.0])))
    b.add_prototype_mesh(f, v)  # placed by no instance
    return b


def test_builder_matches_jax():
    """The builder's instancing calls give the JAX builder's arrays, and
    the same world bound (the instances' transformed boxes)."""
    got = _instanced_calls(SceneBuilder()).finalize("cpu")
    want = _instanced_calls(JaxBuilder()).finalize()
    pt = want.proto_p0.shape[0]
    assert got.n_instances == want.inst_o2w.shape[0] == 17 and got.n_proto_tris == pt
    np.testing.assert_array_equal(got.proto_attr.numpy(), np.asarray(want.proto_attr))
    for k in ("proto_range", "inst_o2w", "inst_w2o", "inst_proto", "inst_mat", "tri_attr",
              "mat_attr", "world_center"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.world_radius == float(want.world_radius)
    np.testing.assert_array_equal(
        got.proto_attr[:pt, sa.TA_P0:sa.TA_P0 + 9].numpy(),
        np.concatenate([np.asarray(getattr(want, k)) for k in ("proto_p0", "proto_p1",
                                                                "proto_p2")], 1))
    # the distant lights' world radius reads the instances' bound
    la = got.light_attr.numpy()
    np.testing.assert_array_equal(la[:got.n_lights, sa.LP_WORLD_RADIUS],
                                  np.float32(got.world_radius))


def test_bridge_carries_instances():
    want = _instanced_calls(JaxBuilder()).finalize()
    got = sa.scene_from_numpy({k: np.asarray(getattr(want, k)) for k in sa.BRIDGE_FIELDS}, "cpu")
    for k in ("proto_attr", "proto_range", "inst_o2w", "inst_w2o", "inst_proto", "inst_mat"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.n_instances == 17 and got.n_proto_tris == want.proto_p0.shape[0]
    assert got.n_anim_tris == 0 and got.anim_xf.shape == (0, 32)
    assert {"proto_p0", "proto_attr", "inst_w2o", "anim_xf", "anim_range"} <= set(sa.BRIDGE_FIELDS)


def test_collect_candidates_match_jax(forest):
    """Phase 1's candidate lists and distances, equal; some rays enter more
    boxes than the walk keeps."""
    res = forest["jax"].results("walk")
    o, d, t_max = forest["rays"]
    w = {}
    cand, cand_t = inst.collect_candidates(o, d, t_max, forest["accel"].inst, work=w)
    np.testing.assert_array_equal(cand.numpy(), res["walk:cand"])
    np.testing.assert_array_equal(cand_t.numpy(), res["walk:cand_t"])
    assert int((w["entered"] > inst.K_CANDIDATES).sum()) > 20
    # the shadow rays start inside boxes: several candidates at distance 0
    assert int((cand_t == 0).sum(1).ge(2).sum()) > 20


def test_instance_walk_matches_jax(forest):
    res = forest["jax"].results("walk")
    o, d, t_max = forest["rays"]
    h = ink.instance_intersect(o, d, t_max, forest["accel"].inst)  # the plain walk on the CPU
    assert 0.2 < float(h.valid.float().mean()) < 0.9
    for k in ("valid", "tri", "inst"):
        np.testing.assert_array_equal(getattr(h, k).numpy(), res["walk:ih_" + k], err_msg=k)
    for k in ("t", "b0", "b1"):
        np.testing.assert_array_equal(getattr(h, k).numpy(), res["walk:ih_" + k], err_msg=k)
    occ = ink.instance_intersect(o, d, t_max, forest["accel"].inst, any_hit=True)
    np.testing.assert_array_equal(occ.numpy(), h.valid.numpy())


def test_scene_intersect_matches_jax(forest):
    res = forest["jax"].results("walk")
    o, d, t_max = forest["rays"]
    it = si.scene_intersect(forest["scene"], o, d, t_max, forest["accel"])
    np.testing.assert_array_equal(it.valid.numpy(), res["walk:it_valid"])
    v = it.valid.numpy()
    for k in ("mat", "light", "prim"):
        np.testing.assert_array_equal(getattr(it, k).numpy(), res["walk:it_" + k], err_msg=k)
    for k in ("t", "p", "p_error", "ng", "ns", "uv", "dpdu"):
        np.testing.assert_allclose(getattr(it, k).numpy()[v], res["walk:it_" + k][v], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    inst_hit = it.prim.numpy() >= forest["scene"].n_tris
    assert inst_hit.sum() > 500 and (it.light.numpy()[inst_hit] == -1).all()
    occ = si.scene_intersect_p(forest["scene"], o, d, t_max, forest["accel"])
    np.testing.assert_array_equal(occ.numpy(), res["walk:occ"])


def test_instances_need_their_accel(forest):
    scene = forest["scene"]
    o, d, t_max = (r[:8] for r in forest["rays"])
    with pytest.raises(ValueError, match="build_accel"):
        si.scene_intersect(scene, o, d, t_max)
    with pytest.raises(ValueError, match="build_accel"):
        si.scene_intersect_p(scene, o, d, t_max, si.Accel())
    assert si.uses_tree(scene, forest["accel"]) and not si.uses_tree(scene, si.Accel())
    assert pk.mega_cfg(scene) is None


def test_kernel_wrapper_checks(forest):
    """The I1/I2 wrapper runs the plain walk on CPU tensors and refuses to
    launch with tensors off the card."""
    acc = forest["accel"].inst
    o, d, t_max = (r[:4] for r in forest["rays"])
    with pytest.raises(ValueError, match="expected CUDA"):
        ink.check_accel(acc)
    before = dict(ink.launches)
    ink.instance_intersect(o, d, t_max, acc)
    assert ink.launches == before
    assert acc.top_box.shape[1] == acc.inner_box.shape[1] == 12
    assert acc.tris.shape == (forest["scene"].n_proto_tris, 9)
    assert acc.top_prim.shape == (forest["scene"].n_instances,)


@pytest.mark.parametrize("tag", sorted(RENDERS))
def test_render_matches_jax(forest, tag, monkeypatch):
    """path through the regeneration loop (1,024 lanes of 4,096 paths) and
    directlighting, per pixel within 2e-3 of the JAX renders."""
    (integ, spp, depth, extra, kind), opt = RENDERS[tag]
    if "lane_width" in opt:
        monkeypatch.setattr(regen, "REGEN_LANE_WIDTH", opt["lane_width"])
    st = {}
    img = rdr.render(forest["scene"], forest["camera"], rdr.RenderCfg(integ, spp, depth, 1.0),
                     smpl.make_sampler(smpl.SOBOL, spp, (RES, RES)), accel=forest["accel"],
                     stats=st).numpy()
    if "lane_width" in opt:
        assert st["lane_width"] == opt["lane_width"] and st["iterations"] > depth + 1
    want = forest["jax"].results(tag)[tag + ":img"]
    assert np.isfinite(img).all() and want.mean() > 0.02
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)
