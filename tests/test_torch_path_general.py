"""rs_pbrt_tpu_torch's general path bounce (models/integrators/path.py
general_radiance, the fixed-depth loop) against the JAX package's
path.radiance(..., regen=False) on the same camera rays and Sobol'
indices, and whole renders against render(..., regen=False): on
spheres_direct (a mirror sphere, so the specular MIS branch runs, and a
sphere light) and on the statue at subdivisions=5 (20,484 triangles,
traversed through its BVH), depth 5, 16x16, 2 spp.

Tolerance: rtol = atol = 2e-3 per lane and per pixel, and the means within
1e-4 relative: the bound the JAX package holds its own two paths to
(tests/test_pallas.py:157-161), the same estimator and samples with float
association the only difference.  The JAX package traverses the statue
with its binary BVH on the CPU and the port with the wide12 one; no lane
flips between them at this size, so no lane needs a wider tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import samplers as jsmpl
from rs_pbrt_tpu.models.integrators import path as jpath
from rs_pbrt_tpu.models.integrators import render as jrdr
from rs_pbrt_tpu.ops import bvh as jbvh
from rs_pbrt_tpu.ops import intersect as jisect
from rs_pbrt_tpu.ops import pallas_intersect as jpin
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene import bigscene as jbig
from rs_pbrt_tpu.scene import presets as jpresets
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import bvh
from rs_pbrt_tpu_torch.ops import intersect as isect
from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
from rs_pbrt_tpu_torch.ops import path_kernel as pk
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
from rs_pbrt_tpu_torch.scene import bigscene
from rs_pbrt_tpu_torch.scene import presets
from test_torch_direct import sample_ctx

torch.set_num_threads(2)

RES, SPP, DEPTH = (16, 16), 2, 5


def scenes(name):
    """(port scene, port camera, port accel, JAX scene, JAX camera, JAX accel)."""
    if name == "spheres_direct":
        scene, camera = presets.spheres_direct(RES, device="cpu")
        return (scene, camera, None) + jpresets.spheres_direct(RES) + (None,)
    jscene, jcamera = jbig.statue_scene(RES, subdivisions=5)
    scene, camera = bigscene.statue_scene(RES, 5, device="cpu")
    return scene, camera, si.build_accel(scene, device="cpu"), jscene, jcamera, \
        jsi.build_accel(jscene)


@pytest.mark.parametrize("name", ["spheres_direct", "statue"])
def test_radiance_matches_jax(name):
    scene, _, accel, jscene, jcamera, jaccel = scenes(name)
    assert pk.mega_cfg(scene) is None  # neither scene takes the bounce kernel
    (jcfg, jctx), (cfg, ctx), o, d = sample_ctx(jcamera, spp=SPP)
    want = np.asarray(jpath.radiance(jscene, jpath.PathCfg(DEPTH, 1.0), jcfg, jctx,
                                     jnp.asarray(o), jnp.asarray(d), jaccel, regen=False))
    got = pathmod.radiance(scene, pathmod.PathCfg(DEPTH, 1.0), cfg, ctx, torch.as_tensor(o),
                           torch.as_tensor(d), accel=accel).numpy()
    assert np.isfinite(got).all() and want.mean() > 0.02
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert abs(got.mean() - want.mean()) < 1e-4 * want.mean()


@pytest.mark.parametrize("name", ["spheres_direct", "statue"])
def test_render_matches_jax(name):
    scene, camera, accel, jscene, jcamera, jaccel = scenes(name)
    img = rdr.render(scene, camera, rdr.RenderCfg("path", SPP, DEPTH, 1.0),
                     smpl.make_sampler(smpl.SOBOL, SPP, RES), accel=accel).numpy()
    want = np.asarray(jrdr.render(jscene, jcamera, jrdr.RenderCfg("path", spp=SPP,
                                                                 max_depth=DEPTH,
                                                                 rr_threshold=1.0),
                                  jsmpl.make_sampler(jsmpl.SOBOL, SPP, RES), accel=jaccel,
                                  regen=False))
    assert img.shape == want.shape == (RES[1], RES[0], 3) and want.mean() > 0.02
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)
    assert abs(img.mean() - want.mean()) < 1e-4 * want.mean()


@pytest.mark.parametrize("name", ["spheres_direct", "statue"])
def test_launch_sequence_matches_jax(name, monkeypatch):
    """The port's general loop intersects where the JAX loop on the TPU does
    (closest hit, then the shadow rays, each bounce, then the emit-only
    pass: B1/B2 through the BVH, K5/K4 on the dense scene) and draws the
    same bounce dims, all of them in one launch before the first bounce,
    from the index's exact width (the render's promise sample < spp).
    The JAX bounce body is a fori_loop's, traced once, so its record holds
    one bounce.
    The intersections are replaced by recorders that report misses, so
    nothing is traced."""
    scene, _, accel, jscene, jcamera, jaccel = scenes(name)
    (jcfg, jctx), (cfg, ctx), o, d = sample_ctx(jcamera, spp=1)
    n = o.shape[0]
    seen_j, seen = [], []

    def jmiss(t_max):
        return jisect.TriHit(jnp.zeros(n, bool), t_max, jnp.full(n, -1, jnp.int32),
                             jnp.zeros(n), jnp.zeros(n))

    def jbvh12(o_, d_, t_max, rows, depth, any_hit=False, **_):
        seen_j.append("any" if any_hit else "closest")
        return jmiss(t_max)

    def jfull(o_, d_, t_max, tri_attr, n_tri):
        seen_j.append("closest")
        z3 = jnp.zeros((n, 3))
        return dict(valid=jnp.zeros(n, bool), t=t_max, prim=jnp.full(n, -1, jnp.int32), p=z3,
                    p_err=z3, ng=z3, ns=z3, uv=jnp.zeros((n, 2)), dpdu=z3,
                    mat=jnp.zeros(n, jnp.int32), light=jnp.full(n, -1, jnp.int32))

    def jany(*_):
        seen_j.append("any")
        return jnp.zeros(n, bool)

    jget_dims = jsmpl.get_dims
    monkeypatch.setattr(jsi, "_use_pallas", lambda: True)
    monkeypatch.setattr(jbvh, "bvh12_intersect_tris", jbvh12)
    monkeypatch.setattr(jpin, "pallas_intersect_tris_full", jfull)
    monkeypatch.setattr(jpin, "pallas_intersect_tris_p", jany)
    monkeypatch.setattr(jsmpl, "get_dims", lambda c, x, dim0, k: seen_j.append(("dims", dim0, k))
                        or jget_dims(c, x, dim0, k))

    def bvh12(o_, d_, t_max, rows, depth, any_hit=False):
        seen.append("any" if any_hit else "closest")
        if any_hit:
            return torch.zeros(n, dtype=torch.bool)
        return isect.TriHit(torch.zeros(n, dtype=torch.bool), t_max,
                            torch.full((n,), -1, dtype=torch.int32), torch.zeros(n),
                            torch.zeros(n))

    def full(o_, d_, t_max, tris, n_tri):
        seen.append("closest")
        rows = torch.zeros((ik.N_F_ROWS, n))
        rows[ik.F_T] = t_max
        return ik.FullHit(rows, torch.tensor([[-1], [0], [-1]], dtype=torch.int32).expand(3, n))

    def any_(*_):
        seen.append("any")
        return torch.zeros(n, dtype=torch.bool)

    sobol_dims, bits_seen = sk.sobol_dims, []
    monkeypatch.setattr(bvh, "bvh12_intersect_tris", bvh12)
    monkeypatch.setattr(ik, "full_sweep", full)
    monkeypatch.setattr(ik, "any_sweep", any_)
    monkeypatch.setattr(sk, "sobol_dims", lambda idx, dim0, k, bits: seen.append(("dims", dim0, k))
                        or bits_seen.append(bits) or sobol_dims(idx, dim0, k, bits))

    jpath.radiance(jscene, jpath.PathCfg(DEPTH, 1.0), jcfg, jctx, jnp.asarray(o), jnp.asarray(d),
                   jaccel, regen=False)
    pathmod.radiance(scene, pathmod.PathCfg(DEPTH, 1.0), cfg, ctx, torch.as_tensor(o),
                     torch.as_tensor(d), accel=accel)
    # the JAX loop is a fori_loop: its body is traced (and recorded) once
    dims_j, *body_j, last_j = seen_j
    assert seen == [dims_j] + body_j * DEPTH + [last_j]
    assert seen == [("dims", pathmod.DIM_CAMERA, pathmod.DIMS_PER_BOUNCE * DEPTH)] + \
        ["closest", "any"] * DEPTH + ["closest"]
    # 16x16 at 1 spp: an index of 2 log2(16) = 8 bits
    assert bits_seen == [smpl.exact_index_bits(cfg)] == [8]


def test_deep_paths_draw_dims_within_k1_limit(monkeypatch):
    """Past sk.MAX_DIMS bounce dims K1 cannot draw them in one launch, so
    the loop draws one bounce's at a time, and the radiance is still the
    JAX loop's (which hoists all of them up to 128).  sobol_dims is patched
    to refuse what the kernel refuses, since its plain version has no cap."""
    depth = sk.MAX_DIMS // pathmod.DIMS_PER_BOUNCE + 1
    scene, _, accel, jscene, jcamera, jaccel = scenes("spheres_direct")
    (jcfg, jctx), (cfg, ctx), o, d = sample_ctx(jcamera, spp=1)
    sobol_dims, seen = sk.sobol_dims, []

    def capped(idx, dim0, k, bits):
        assert 1 <= k <= sk.MAX_DIMS, f"K1 refuses {k} dims"
        seen.append((dim0, k))
        return sobol_dims(idx, dim0, k, bits)

    monkeypatch.setattr(sk, "sobol_dims", capped)
    got = pathmod.radiance(scene, pathmod.PathCfg(depth, 1.0), cfg, ctx, torch.as_tensor(o),
                           torch.as_tensor(d), accel=accel).numpy()
    assert seen == [(pathmod.DIM_CAMERA + b * pathmod.DIMS_PER_BOUNCE, pathmod.DIMS_PER_BOUNCE)
                    for b in range(depth)]
    want = np.asarray(jpath.radiance(jscene, jpath.PathCfg(depth, 1.0), jcfg, jctx,
                                     jnp.asarray(o), jnp.asarray(d), jaccel, regen=False))
    assert np.isfinite(got).all() and want.mean() > 0.02
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_depth_10_draws_bounce_dims_in_one_launch(monkeypatch):
    """At depth 10 the 70 bounce dims are one K1 launch (K1 draws up to
    128, as the JAX package hoists them), and the radiance is the JAX
    loop's."""
    depth = 10
    scene, _, accel, jscene, jcamera, jaccel = scenes("spheres_direct")
    (jcfg, jctx), (cfg, ctx), o, d = sample_ctx(jcamera, spp=1)
    sobol_dims, seen = sk.sobol_dims, []
    monkeypatch.setattr(sk, "sobol_dims", lambda idx, dim0, k, bits: seen.append((dim0, k))
                        or sobol_dims(idx, dim0, k, bits))
    got = pathmod.radiance(scene, pathmod.PathCfg(depth, 1.0), cfg, ctx, torch.as_tensor(o),
                           torch.as_tensor(d), accel=accel).numpy()
    assert seen == [(pathmod.DIM_CAMERA, pathmod.DIMS_PER_BOUNCE * depth)]
    assert pathmod.DIMS_PER_BOUNCE * depth <= sk.MAX_DIMS == 128
    want = np.asarray(jpath.radiance(jscene, jpath.PathCfg(depth, 1.0), jcfg, jctx,
                                     jnp.asarray(o), jnp.asarray(d), jaccel, regen=False))
    assert np.isfinite(got).all() and want.mean() > 0.02
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_unported_parts_raise():
    scene, camera = bigscene.statue_scene((8, 8), 5, device="cpu")
    scfg = smpl.make_sampler(smpl.SOBOL, 1, (8, 8))
    with pytest.raises(NotImplementedError, match="build_accel"):
        rdr.render(scene, camera, rdr.RenderCfg("path", 1, 2, 1.0), scfg)
    with pytest.raises(ValueError, match="'bvh', 'kdtree'"):
        rdr.render(scene, camera, rdr.RenderCfg("path", 1, 2, 1.0, accelerator="octree"), scfg,
                   accel=si.build_accel(scene, device="cpu"))
    small, camera = presets.spheres_direct((8, 8), device="cpu")
    before = rdr.render(small, camera, rdr.RenderCfg("path", 1, 2, 1.0), scfg)
    small.has_alpha = True  # alpha masks render (no triangle holds one here)
    assert torch.equal(rdr.render(small, camera, rdr.RenderCfg("path", 1, 2, 1.0), scfg), before)
    small.has_alpha = False
    small.n_instances = True  # instances render through their trees only
    with pytest.raises(ValueError, match="build_accel"):
        rdr.render(small, camera, rdr.RenderCfg("path", 1, 2, 1.0), scfg)
    small.n_instances = False
