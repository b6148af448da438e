"""rs_pbrt_tpu_torch's alpha and shadow-alpha masks (ops/scene_intersect.py
alpha_masked, alpha_recast_loop) and bump maps (ops/bsdf.apply_bump)
against the JAX package's: the quads of tests/test_alpha.py (a checker
alpha over a plain quad, a mask that cuts everything, a shadow-alpha mask
that only shadow rays see), brute force and through the BVH (the back
quad tessellated past scene_intersect.BRUTE_FORCE_MAX_TRIS), on the JAX
test's rays and on seeded random rays; and apply_bump's frame on a
bump-mapped quad and sphere.

Tolerances: hits and occlusion equal, t within 1e-4 (the recast's offset
origins, XLA's fused multiply-adds in this process); the bumped frame per
lane within 1e-5 of the JAX one.

The JAX queries run jitted with the scene as an argument, and every
brute-force case builds tables of one shape (each case makes both front
masks' textures and binds those it names), so XLA compiles the recast
loop once for them all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models.integrators import path as jpath
from rs_pbrt_tpu.ops import bsdf as jbx
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.ops import bsdf as bx
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.ops import texture as tx
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools.material_scenes import ground_mesh
from rs_pbrt_tpu_torch.utils import transform as tr


def _quad(b, z, material, cells=1, **kw):
    """The quad [-1, 1]^2 at depth z, uv over [0, 1]^2, in cells^2 squares."""
    idx, pos = ground_mesh(1.0, cells)
    pos = np.stack([pos[:, 0], pos[:, 2], np.full(len(pos), z)], -1).astype(np.float32)
    b.add_triangle_mesh(idx, pos, uvs=(pos[:, :2] + 1.0) / 2.0, material=material, **kw)


def _checker(b, su, first, second):
    c = lambda v: b.add_texture(tx.TEX_CONSTANT, {tx.TP_VALUE: (v,) * 3})
    return b.add_texture(tx.TEX_CHECKER, {tx.TP_SU: su, tx.TP_SV: su}, children=(c(first),
                                                                               c(second)))


CASES = {
    # front quad's masks, the back quad's cells (48: a BVH)
    "checker": dict(alpha=(2.0, 1.0, 0.0), salpha=None),
    "all_cut": dict(alpha=(1.0, 0.0, 0.0), salpha=None),
    "shadow_only": dict(alpha=None, salpha=(1.0, 0.0, 0.0)),
    "both": dict(alpha=(4.0, 1.0, 0.0), salpha=(3.0, 0.0, 1.0)),
}


_JAX_HIT = jax.jit(jsi.scene_intersect)
_JAX_OCCLUDED = jax.jit(jsi.scene_intersect_p)


def _build(b, case, cells):
    m = b.add_matte()
    kw = {}
    for key, arg in (("alpha", "alpha_tex"), ("salpha", "shadow_alpha_tex")):
        tex = _checker(b, *(CASES[case][key] or (1.0, 1.0, 1.0)))
        if CASES[case][key] is not None:
            kw[arg] = tex
    _quad(b, 1.0, m, **kw)
    _quad(b, 2.0, m, cells=cells)
    _quad(b, 2.5, m, alpha_tex=_checker(b, 5.0, 0.0, 1.0))  # a second masked sheet behind
    return b


def _rays(seed, n=4096):
    xy = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]], np.float32)
    rng = np.random.default_rng(seed)
    xy = np.concatenate([xy, rng.uniform(-1.2, 1.2, (n, 2)).astype(np.float32)])
    o = np.concatenate([xy, np.full((len(xy), 1), -1.0, np.float32)], 1)
    d = np.tile(np.array([[0, 0, 1.0]], np.float32), (len(xy), 1))
    d[4:, :2] += rng.normal(0, 0.05, (n, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("case, cells", [(c, 1) for c in sorted(CASES)] + [("both", 48)])
def test_masks_match_jax(case, cells):
    js = _build(JaxBuilder(), case, cells).finalize()
    ps = _build(SceneBuilder(), case, cells).finalize("cpu")
    assert ps.has_alpha and js.has_alpha
    jacc = jsi.build_accel(js) if cells > 1 else None
    pacc = si.build_accel(ps, device="cpu") if cells > 1 else None
    assert si.uses_bvh(ps, pacc) == (cells > 1)
    o, d = _rays(cells)
    t_max = np.full(len(o), 100.0, np.float32)
    jit = _JAX_HIT(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jacc)
    pit = si.scene_intersect(ps, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
                             pacc)
    valid = pit.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jit.valid))
    np.testing.assert_allclose(pit.t.numpy()[valid], np.asarray(jit.t)[valid], atol=1e-4)
    jocc = np.asarray(_JAX_OCCLUDED(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                    jacc))
    pocc = si.scene_intersect_p(ps, torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(t_max), pacc).numpy()
    np.testing.assert_array_equal(pocc, jocc)
    t_front = pit.t.numpy()[:4]
    # shadow rays that end before the back quads (tests/test_alpha.py's)
    t_front_only = np.full(len(o), 2.5, np.float32)
    jocc = np.asarray(_JAX_OCCLUDED(js, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t_front_only), jacc))
    pocc = si.scene_intersect_p(ps, torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(t_front_only), pacc).numpy()
    np.testing.assert_array_equal(pocc, jocc)
    if case == "checker":  # tests/test_alpha.py: even cells stop at the front quad
        np.testing.assert_allclose(t_front[[0, 2]], 2.0, atol=1e-3)
        np.testing.assert_allclose(t_front[[1, 3]], 3.0, atol=1e-3)
        assert pocc[[0, 2]].all() and not pocc[[1, 3]].any()
    if case == "shadow_only":  # primary rays hit; shadow rays pass the front quad
        np.testing.assert_allclose(t_front, 2.0, atol=1e-3)


def test_recast_budget_and_stats():
    """A stack of 20 fully cut sheets in front of a plain one: 16 recasts,
    then the lanes still masked count as misses (scene_intersect.py:374-383
    of the JAX package); the stats count the trips and the lanes left."""
    b = SceneBuilder()
    m = b.add_matte()
    cut = b.add_texture(tx.TEX_CONSTANT, {tx.TP_VALUE: (0.0,) * 3})
    for k in range(20):
        _quad(b, 1.0 + 0.01 * k, m, alpha_tex=cut)
    _quad(b, 2.0, m)
    scene = b.finalize("cpu")
    o, d = (torch.as_tensor(a[:64]) for a in _rays(0))
    t_max = torch.full((64,), 100.0)
    it = si._scene_intersect_once(scene, o, d, t_max, None)
    st = {}
    out = si.alpha_recast_loop(scene, o, d, t_max, None, it, shadow=False, stats=st)
    assert st["alpha_trips"] == si.MAX_ALPHA_RECASTS
    hits_front = it.valid
    assert st["alpha_left"] == int(hits_front.sum()) > 0
    assert not out.valid[hits_front].any()


def _bump_scenes():
    def build(b):
        m = b.add_matte()
        uv = b.add_texture(tx.TEX_UV, {tx.TP_SU: 3.0, tx.TP_SV: 2.0})
        b.set_material_texture(m, sa.TEX_SLOT_BUMP, b.add_texture(
            tx.TEX_SCALE, children=(uv, b.add_texture(tx.TEX_CONSTANT,
                                                      {tx.TP_VALUE: (0.2,) * 3}))))
        m2 = b.add_plastic()
        b.set_material_texture(m2, sa.TEX_SLOT_BUMP, b.add_texture(
            tx.TEX_FBM, {tx.TP_VALUE: (0.05,) * 3, tx.TP_OCTAVES: 4},
            world_to_texture=tr.scale(0.25, 0.25, 0.25)))
        _quad(b, 2.0, m)
        b.add_sphere(tr.translate([0.0, 0.0, 1.0]), radius=0.4, material=m2)
        b.add_sphere(tr.translate([0.7, 0.7, 1.2]), radius=0.2, material=b.add_matte())
        return b
    return build(JaxBuilder()).finalize(), build(SceneBuilder()).finalize("cpu")


def test_apply_bump_matches_jax():
    """On the JAX package's hits and frames (the finite difference divides
    the hit records' ulps by the step 0.0005, so each package's own records
    would part by ~1e-4), the bumped frame within 1e-5 per lane."""
    js, ps = _bump_scenes()
    o, d = _rays(5)
    t_max = np.full(len(o), 100.0, np.float32)
    jit = jsi.scene_intersect(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    pit = si.scene_intersect(ps, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    np.testing.assert_array_equal(pit.mat.numpy(), np.asarray(jit.mat))
    jss, jts = jpath._shading_frame_du(jit.ns, jit.dpdu)
    jns, jss_b, jts_b = jbx.apply_bump(js, jit, jss, jts)
    t = lambda x: torch.tensor(np.asarray(x))
    pit = si.Interaction(*(t(x) for x in jit))
    pns, pss, pts = bx.apply_bump(ps, pit, t(jss), t(jts))
    hit = pit.valid.numpy()
    for got, want in ((pns, jns), (pss, jss_b), (pts, jts_b)):
        np.testing.assert_allclose(got.numpy()[hit], np.asarray(want)[hit], rtol=1e-5, atol=1e-5)
    bumped = np.isin(pit.mat.numpy(), (1, 2)) & hit
    moved = (pns - pit.ns).norm(dim=-1).numpy()
    assert (moved[bumped] > 1e-3).mean() > 0.9 and (moved[~bumped] == 0).all()
