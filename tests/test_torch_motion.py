"""rs_pbrt_tpu_torch's object motion (utils/animated.py's motion_bounds and
inverse_affine, the builder's add_animated_triangle_mesh, the V1 wrapper
ops/motion_kernel.py, ray time through the path integrator) against the
JAX package's, and the bounce kernel's gate for scenes it cannot render.

- motion_bounds and inverse_affine against the JAX functions at rtol 1e-6.
- _anim_hits per lane: two groups (tests/_a25scene.two_groups), one
  turning 200 degrees (past 180: the slerp's shortest-arc flip), one
  growing from scale 0.5 to 1.5, at random times in [0, 1] with times 0
  and 1 among them, the JAX side computed a group at a time (the JAX
  function fails to broadcast two groups), the nearer of the two kept:
  valid, tri and grp equal, t, b0, b1 within rtol =
  atol = 1e-5 (XLA's arccos and sin and the one-hot einsum may round
  otherwise than torch's; the JAX side runs without FMA contraction in a
  subprocess, tests/_a25scene.py), shadow rays' occlusion equal.
- The moving Cornell box (tools/instance_scenes.moving_build) rendered by
  path (the general bounce, each path at its camera ray's time) and by
  volpath (time 0), per pixel within 2e-3 of the JAX renders.
- The gate: before this slice path_kernel.mega_cfg took a scene with an
  animated mesh or with instances, and K2 then swept the static triangles
  only; it refuses both now, and the moving box takes the general bounce.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _a25scene import FOREST, RES, JaxJobs, two_groups
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu.utils import animated as jan
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import motion_kernel as mok
from rs_pbrt_tpu_torch.ops import path_kernel as pk
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import instance_scenes as isc
from rs_pbrt_tpu_torch.utils import animated as an
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)
# the JAX subprocesses start before the first test, so they compile while
# the tests that need none run
pytestmark = pytest.mark.usefixtures("jax_side")

FLT_MAX = np.finfo(np.float32).max
N_RAYS = 2048
RENDERS = {"path": ("path", 4, 5, None, "bvh"), "volpath": ("volpath", 2, 5, None, "bvh")}


def group_rays(seed=0):
    """(o, d, t_max, time) numpy f32: rays from around the two groups aimed
    near their paths, times uniform in [0, 1] with the first 64 at 0 and
    the next 64 at 1, a quarter of limited length and 64 dead."""
    rng = np.random.default_rng(seed)
    n = N_RAYS
    o = rng.uniform([-4, -2, 4], [4, 3, 6], (n, 3))
    aim = np.where(rng.uniform(size=n)[:, None] < 0.5, [-1.2, 0.4, 0.1], [1.5, 0.1, 0.0])
    d = aim + rng.normal(0, 0.8, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = rng.uniform(0, 1, n)
    time[:64], time[64:128] = 0.0, 1.0
    t_max = np.full(n, FLT_MAX)
    t_max[256:768] = rng.uniform(2.0, 7.0, 512)
    t_max[-64:] = -1.0
    return [a.astype(np.float32) for a in (o, d, t_max, time)]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    o, d, t_max, time = group_rays()
    # volpath (the longest compile) in one subprocess, the two groups'
    # sweeps and then path in the other
    rays = {f"group{g}:{k}": a for g in (0, 1)
            for k, a in (("o", o), ("d", d), ("t_max", t_max), ("time", time))}
    render = {tag: ("render", dict(scene="moving", cfg=cfg)) for tag, cfg in RENDERS.items()}
    jax = JaxJobs(tmp_path_factory.mktemp("motion"))
    jax.start({"volpath": render["volpath"]})
    jax.start({"group0": ("anim", dict(scene="group0")), "group1": ("anim", dict(scene="group1")),
               "path": render["path"]}, rays)
    yield jax
    jax.close()


@pytest.fixture(scope="module")
def moving():
    return isc.moving_scene((RES, RES), device="cpu")


def test_motion_bounds_and_inverse_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3))
    for k in range(6):
        m0 = np.eye(4)
        m0[:3, :3] = rng.normal(size=(3, 3)) + 2 * np.eye(3)
        m0[:3, 3] = rng.normal(size=3)
        m1 = np.eye(4)
        m1[:3, :3] = rng.normal(size=(3, 3)) + 2 * np.eye(3)
        m1[:3, 3] = rng.normal(size=3)
        parts = an.decompose(m0) + an.decompose(m1)
        for g, w in zip(an.motion_bounds(*parts, pts), jan.motion_bounds(*parts, pts)):
            np.testing.assert_allclose(g, w, rtol=1e-6)
        t = np.linspace(0, 1, 7, dtype=np.float32)
        got = an.inverse_affine(an.interpolate(torch.as_tensor(t),
                                               *(torch.as_tensor(p) for p in parts)))
        want = jan.inverse_affine(jan.interpolate(jnp.asarray(t), *parts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        # the inverse undoes the matrix
        m = an.interpolate(torch.as_tensor(t), *(torch.as_tensor(p) for p in parts))
        eye = torch.einsum("nij,njk->nik", m.double(), got.double())
        np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(4), eye.shape), atol=1e-4)


def test_interpolate_per_group_matches_per_camera():
    """The broadcast form (one lane a row, one group a column) gives each
    group's own interpolation bit for bit."""
    scene = two_groups(SceneBuilder(), tr).finalize("cpu")
    t = torch.linspace(0, 1, 11)
    both = an.interpolate(t[:, None], *an.xf_parts(scene.anim_xf[None]))
    for g in range(2):
        one = an.interpolate(t, *an.xf_parts(scene.anim_xf[g]))
        assert torch.equal(both[:, g], one)


def _moving_calls(b):
    """The moving box, and a mirrored animated mesh (its orientation flips)."""
    isc.moving_build(b)
    v, f = isc.statue_mesh(0)
    b.add_animated_triangle_mesh(f, v, tr.from_matrix(np.diag([-1.0, 1.0, 1.0, 1.0])),
                                 tr.from_matrix(np.diag([-2.0, 1.0, 1.0, 1.0])), uvs=v[:, :2],
                                 reverse_orientation=False)
    return b


def test_builder_matches_jax():
    got = _moving_calls(SceneBuilder()).finalize("cpu")
    want = _moving_calls(JaxBuilder()).finalize()
    assert got.n_anim_tris == want.anim_p0.shape[0] == 1280 + 20
    for k in ("anim_attr", "anim_range", "anim_xf", "tri_attr", "world_center"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.world_radius == float(want.world_radius)
    rev = got.anim_attr[1280:, sa.TA_REVERSE]
    assert (rev == 1.0).all() and (got.anim_attr[:1280, sa.TA_REVERSE] == 0.0).all()


def test_bridge_carries_animated_meshes():
    want = _moving_calls(JaxBuilder()).finalize()
    got = sa.scene_from_numpy({k: np.asarray(getattr(want, k)) for k in sa.BRIDGE_FIELDS}, "cpu")
    for k in ("anim_attr", "anim_range", "anim_xf", "world_center"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.n_anim_tris == 1300 and got.n_instances == 0
    np.testing.assert_array_equal(
        got.anim_attr[:, sa.TA_P0:sa.TA_P0 + 9].numpy(),
        np.concatenate([np.asarray(getattr(want, k)) for k in ("anim_p0", "anim_p1", "anim_p2")],
                       1))


def jax_two_groups(res):
    """The JAX _anim_hits of two_groups' meshes, each computed on its own:
    the nearer hit of the two, the first group's at equal t (the argmin
    over the groups' rows in order), the second's rows after the
    first's."""
    g0, g1 = ({k: res[f"group{g}:{k}"] for k in ("valid", "t", "tri", "b0", "b1", "occ")}
              for g in (0, 1))
    second = g1["valid"] & (~g0["valid"] | (g1["t"] < g0["t"]))
    out = {k: np.where(second, g1[k], g0[k]) for k in ("valid", "t", "b0", "b1")}
    out["tri"] = np.where(second, g1["tri"] + 8, g0["tri"])
    out["grp"] = second.astype(np.int32)
    out["occ"] = g0["occ"] | g1["occ"]
    return out


def test_anim_hits_match_jax(jax_side):
    res = jax_two_groups(jax_side.results("group0", "group1"))
    scene = two_groups(SceneBuilder(), tr).finalize("cpu")
    o, d, t_max, time = (torch.as_tensor(a) for a in group_rays())
    w = {}
    h = mok.anim_hits_plain(o, d, t_max, time, scene, work=w)
    assert w["rays"] == N_RAYS - 64 and w["tests"] == w["rays"] * scene.n_anim_tris
    v = h["valid"].numpy()
    assert 0.15 < v.mean() < 0.85 and v[:128].any()
    np.testing.assert_array_equal(v, res["valid"])
    assert set(np.unique(h["grp"].numpy()[v])) == {0, 1}
    for k in ("tri", "grp"):
        np.testing.assert_array_equal(h[k].numpy(), res[k], err_msg=k)
    for k in ("t", "b0", "b1"):
        np.testing.assert_allclose(h[k].numpy(), res[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    occ = si.scene_intersect_p(scene, o, d, t_max, None, time)
    np.testing.assert_array_equal(occ.numpy(), res["occ"])
    # the wrapper runs the plain version on the CPU and launches nothing
    before = dict(mok.launches)
    assert torch.equal(mok.anim_hits(o, d, t_max, time, scene, any_hit=True), h["valid"])
    assert mok.launches == before
    with pytest.raises(ValueError, match="expected CUDA"):
        mok._check("o", o, torch.float32, o.shape)


def test_the_slerp_flips_to_the_shorter_arc():
    """The first group's rotation passes 180 degrees: its quaternions' dot
    product is negative, and the interpolation follows the shorter arc."""
    scene = two_groups(SceneBuilder(), tr).finalize("cpu")
    xf = scene.anim_xf[0]
    assert float((xf[3:7] * xf[19:23]).sum()) < 0.0
    m = an.interpolate(torch.tensor([0.5]), *an.xf_parts(xf))
    want = jan.interpolate(jnp.asarray([0.5]), *[np.asarray(p) for p in an.xf_parts(xf)])
    np.testing.assert_allclose(m.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _forest_small():
    return isc.forest_scene((8, 8), subdivisions=1, grid=2, device="cpu")[0]


@pytest.mark.parametrize("case", ["moving", "forest"])
def test_bounce_kernel_refuses(case, moving):
    """The fault repaired: mega_cfg returned a config for these scenes (its
    gate tested neither n_anim_tris nor n_instances), and K2 rendered their
    static triangles alone.  The same scene without the moving mesh or the
    instances still takes K2."""
    scene = moving[0] if case == "moving" else _forest_small()
    assert pk.mega_cfg(scene) is None
    assert pk.mega_cfg(presets.cornell_box((8, 8), device="cpu")[0]) is not None
    # the old gate: every test but the two new ones passes on these scenes
    field = "n_anim_tris" if case == "moving" else "n_instances"
    count = getattr(scene, field)
    setattr(scene, field, 0)
    try:
        assert pk.mega_cfg(scene) is not None
    finally:
        setattr(scene, field, count)


def test_moving_box_takes_the_general_bounce(moving, monkeypatch):
    scene, camera = moving
    calls = []
    monkeypatch.setattr(pk, "mega_radiance", lambda *a, **k: calls.append(1))
    real = pathmod.general_radiance
    seen = {}

    def general(*a, **k):
        seen["time"] = a[-1] if len(a) > 9 else k.get("time")
        return real(*a, **k)

    monkeypatch.setattr(pathmod, "general_radiance", general)
    img = rdr.render(scene, camera, rdr.RenderCfg("path", 1, 2, 1.0),
                     smpl.make_sampler(smpl.SOBOL, 1, (RES, RES)))
    assert not calls and torch.isfinite(img).all()
    assert seen["time"] is not None and float(seen["time"].max()) > 0.5


@pytest.mark.parametrize("tag", sorted(RENDERS))
def test_render_matches_jax(jax_side, moving, tag):
    """path (its casts at each path's time) and volpath (time 0), per pixel
    within 2e-3 of the JAX renders (the JAX path on the CPU takes its
    general wavefront, never its bounce kernel)."""
    scene, camera = moving
    integ, spp, depth, extra, _ = RENDERS[tag]
    img = rdr.render(scene, camera, rdr.RenderCfg(integ, spp, depth, 1.0),
                     smpl.make_sampler(smpl.SOBOL, spp, (RES, RES))).numpy()
    want = jax_side.results(tag)[tag + ":img"]
    assert np.isfinite(img).all() and want.mean() > 0.02
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)
