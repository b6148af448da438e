"""rs_pbrt_tpu_torch's path regeneration (models/integrators/regen.py) on
the CPU: the statue at subdivisions=5 (20,484 triangles, traversed through
its BVH), 16x16, 2 spp, depth 5.

Tolerances.  Against the port's fixed-depth loop (general_radiance) per
path rtol 1e-5, atol 1e-6, and between two lane widths rtol 1e-6, atol
1e-7: the JAX package's own bounds for its loop (tests/test_regen.py:47-63),
since every path takes the same samples and arithmetic in both.  Against
the JAX package's regen.radiance_regen on the same rays and Sobol' indices
rtol = atol = 2e-3 per path and the means within 1e-4 relative, the bound
test_torch_path_general.py holds the two fixed-depth loops to (the JAX
package traverses its binary BVH, the port the wide12 one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models.integrators import path as jpath
from rs_pbrt_tpu.models.integrators import regen as jregen
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene import bigscene as jbig
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import regen
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import bvh
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import bigscene
from rs_pbrt_tpu_torch.scene import presets
from test_torch_direct import sample_ctx

torch.set_num_threads(2)

RES, SPP, DEPTH = (16, 16), 2, 5
PCFG = pathmod.PathCfg(DEPTH, 1.0)


@pytest.fixture(scope="module")
def statue():
    scene, camera = bigscene.statue_scene(RES, 5, device="cpu")
    return scene, camera, si.build_accel(scene, device="cpu")


def camera_paths(statue, spp=SPP):
    """(sampler cfg, ctx, ray o, ray d) of every pixel at spp, as render
    lays them out."""
    _, camera, _ = statue
    scfg = smpl.make_sampler(smpl.SOBOL, spp, RES)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, spp)
    return scfg, ctx, rays.o, rays.d


def test_regen_matches_fixed_depth(statue):
    """Lane width 128 of 512 paths: every lane is refilled several times."""
    scene, _, accel = statue
    scfg, ctx, o, d = camera_paths(statue)
    st = {}
    got = regen.radiance_regen(scene, PCFG, scfg, ctx, o, d, accel, lane_width=128, stats=st)
    want = pathmod.general_radiance(scene, PCFG, scfg, ctx, o, d, accel)
    assert got.shape == want.shape == (RES[0] * RES[1] * SPP, 3)
    assert torch.isfinite(got).all() and float(want.mean()) > 0.02
    # more iterations than one pass of the pool takes: lanes were refilled
    assert st["iterations"] > DEPTH + 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_lane_width_invariance(statue):
    """Widths 128 and 777 of 1,024 paths (4 spp, so that 777 refills too)."""
    scene, _, accel = statue
    scfg, ctx, o, d = camera_paths(statue, spp=4)
    a = regen.radiance_regen(scene, PCFG, scfg, ctx, o, d, accel, lane_width=128)
    b = regen.radiance_regen(scene, PCFG, scfg, ctx, o, d, accel, lane_width=777)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_matches_jax_regen(statue):
    scene, _, accel = statue
    jscene, jcamera = jbig.statue_scene(RES, subdivisions=5)
    (jcfg, jctx), (cfg, ctx), o, d = sample_ctx(jcamera, spp=SPP)
    want = np.asarray(jregen.radiance_regen(jscene, jpath.PathCfg(DEPTH, 1.0), jcfg, jctx,
                                            jnp.asarray(o), jnp.asarray(d),
                                            jsi.build_accel(jscene), lane_width=128))
    got = regen.radiance_regen(scene, PCFG, cfg, ctx, torch.tensor(o), torch.tensor(d), accel,
                               lane_width=128).numpy()
    assert np.isfinite(got).all() and want.mean() > 0.02
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert abs(got.mean() - want.mean()) < 1e-4 * want.mean()


def test_render_regen_matches_fixed_depth(statue, monkeypatch):
    """render's default takes the regeneration loop through a BVH once a
    batch holds more paths than one lane width, and gives the fixed-depth
    render's image; max_lanes of 256 paths makes two batches of 1 spp."""
    scene, camera, accel = statue
    monkeypatch.setattr(regen, "REGEN_LANE_WIDTH", 100)
    cfg = rdr.RenderCfg("path", SPP, DEPTH, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, SPP, RES)
    calls = []
    real = regen.radiance_regen
    monkeypatch.setattr(regen, "radiance_regen", lambda *a, **k: calls.append(a[4].shape[0])
                        or real(*a, **k))
    on, off = {}, {}
    img = rdr.render(scene, camera, cfg, scfg, accel=accel, max_lanes=256, stats=on).numpy()
    assert calls == [256, 256]
    want = rdr.render(scene, camera, cfg, scfg, accel=accel, regen=False, stats=off).numpy()
    assert len(calls) == 2
    assert np.isfinite(img).all() and img.shape == (RES[1], RES[0], 3)
    np.testing.assert_allclose(img, want, rtol=1e-5, atol=1e-6)
    assert on["batches"] == 2 and on["lane_width"] == 100
    assert on["iterations"] > 2 * (DEPTH + 1)
    assert off["batches"] == 1 and off["lane_width"] == 0 and off["iterations"] == 0
    assert on["max_ray_casts"] == off["max_ray_casts"] == 512 * (DEPTH + 1) * 2


def test_drain_iterations_are_no_ops(statue, monkeypatch):
    """Three iterations forced past the drain, with every lane dead: each
    launches its traversals, casts no ray and changes no path's radiance
    (a lane without a path writes only the spare row)."""
    scene, _, accel = statue
    scfg, ctx, o, d = camera_paths(statue)
    launches, extra = [], [0]
    real_isect, real_remain = bvh.bvh12_intersect_tris, regen._paths_remain
    monkeypatch.setattr(bvh, "bvh12_intersect_tris", lambda *a, **k: launches.append(
        (k.get("any_hit", False), int((a[2] >= 0).sum()))) or real_isect(*a, **k))

    def remain(alive):
        # once every path is done, report paths left `extra` more times
        if real_remain(alive):
            return True
        extra[0] -= 1
        return extra[0] >= 0

    monkeypatch.setattr(regen, "_paths_remain", remain)
    runs = []
    for n_extra in (0, 3):
        st, launches[:], extra[0] = {}, [], n_extra
        runs.append((regen.radiance_regen(scene, PCFG, scfg, ctx, o, d, accel, lane_width=128,
                                          stats=st), st["iterations"], list(launches)))
    (a, n_a, la), (b, n_b, lb) = runs
    assert torch.equal(a, b)
    assert n_b == n_a + 3 and len(la) == 2 * n_a and len(lb) == 2 * n_b
    assert lb[:len(la)] == la
    # the extra iterations cast no ray: every lane's t_max is -1
    assert lb[len(la):] == [(False, 0), (True, 0)] * 3


def test_one_lane_width_takes_fixed_depth_loop(statue, monkeypatch):
    """No more paths than one lane width, or no BVH to traverse: radiance
    with regen takes the fixed-depth loop."""
    scene, _, accel = statue
    scfg, ctx, o, d = camera_paths(statue)
    n = o.shape[0]
    seen = []
    real = regen.radiance_regen
    monkeypatch.setattr(regen, "radiance_regen", lambda *a, **k: seen.append(k["stats"])
                        or real(*a, **k))
    want = pathmod.general_radiance(scene, PCFG, scfg, ctx, o, d, accel)
    monkeypatch.setattr(regen, "REGEN_LANE_WIDTH", n)
    got = pathmod.radiance(scene, PCFG, scfg, ctx, o, d, accel=accel, regen=True)
    assert seen == [] and torch.equal(got, want)
    assert not regen.eligible(scene, PCFG, scfg, accel, n)
    assert regen.eligible(scene, PCFG, scfg, accel, n, lane_width=n - 1)
    monkeypatch.setattr(regen, "REGEN_LANE_WIDTH", n - 1)
    pathmod.radiance(scene, PCFG, scfg, ctx, o, d, accel=accel, regen=True)
    assert len(seen) == 1
    # below BRUTE_FORCE_MAX_TRIS build_accel gives no tree: the dense sweeps
    small, camera = presets.spheres_direct((8, 8), device="cpu")
    small_accel = si.build_accel(small, device="cpu")
    assert small_accel.tri is None
    assert not regen.eligible(small, PCFG, scfg, small_accel, 1 << 20, lane_width=1)
    monkeypatch.setattr(regen, "REGEN_LANE_WIDTH", 1)
    st = {}
    rdr.render(small, camera, rdr.RenderCfg("path", 1, 2, 1.0), scfg, accel=small_accel, stats=st)
    assert seen == [None] and st["lane_width"] == st["iterations"] == 0
