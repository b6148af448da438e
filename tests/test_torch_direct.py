"""rs_pbrt_tpu_torch's whitted and directlighting integrators, and the
light, BSDF and sampler parts they use, against the JAX package on the same
inputs (slice 2: BASELINE config 2, presets.spheres_direct).

Tolerances: the light samples and BSDF values within rtol = atol = 1e-4
(the same formulas, float association and library transcendentals the only
difference); Sobol' samples bit-equal; per-lane radiance and whole renders
within rtol = atol = 2e-3, the bound of slice 1 (the JAX package's own
megakernel-vs-general bound, tests/test_pallas.py:157-161).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import cameras as jcam
from rs_pbrt_tpu.models import lights as jlt
from rs_pbrt_tpu.models import samplers as jsmpl
from rs_pbrt_tpu.models.integrators import direct as jdirect
from rs_pbrt_tpu.models.integrators import render as jrdr
from rs_pbrt_tpu.ops import bsdf as jbx
from rs_pbrt_tpu.ops import pallas_intersect as jpin
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene import presets as jpresets
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.models import lights as lt
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import direct
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import bsdf as bx
from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from test_torch_scene import assert_tables_equal, bridge

torch.set_num_threads(2)

RES, SPP, DEPTH = (16, 16), 4, 3


def scenes():
    """(port scene, JAX scene, JAX camera) of spheres_direct at 16x16."""
    jscene, jcamera = jpresets.spheres_direct(RES)
    return presets.spheres_direct(RES, device="cpu")[0], jscene, jcamera


def t32(a):
    return torch.tensor(np.asarray(a))


def test_spheres_direct_tables():
    """The port's builder gives the JAX builder's tables, spheres and the
    sphere light included, and the bridge carries them across."""
    scene, jscene, _ = scenes()
    for port in (scene, bridge(jscene)):
        assert_tables_equal(port, jscene)
        np.testing.assert_array_equal(port.sph_attr.numpy(), np.asarray(jscene.sph_attr))
        assert (port.n_spheres, port.quad_kind_mask, port.mat_kind_mask, port.has_sphere_lights) \
            == (jscene.n_spheres, jscene.quad_kind_mask, jscene.mat_kind_mask, True)


@pytest.mark.parametrize("where", ["floor", "inside-sphere"])
def test_sample_li(where):
    """Both lights sampled from the same points: the quad light (triangle
    range) and the sphere light, by cone from outside it and by area from
    inside."""
    scene, jscene, _ = scenes()
    rng = np.random.default_rng(21)
    n = 512
    if where == "floor":
        ref = np.stack([rng.uniform(-5, 5, n), np.zeros(n), rng.uniform(-5, 5, n)], -1)
    else:  # within 0.25 of the sphere light's center (radius 0.3)
        v = rng.normal(size=(n, 3))
        ref = np.array([2.5, 2.5, -2.0]) + 0.25 * rng.uniform(size=(n, 1)) * v / np.linalg.norm(
            v, axis=1, keepdims=True)
    ref = ref.astype(np.float32)
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    for light in range(scene.n_lights):
        idx = np.full(n, light, np.int32)
        got = lt.sample_li(scene, torch.as_tensor(idx), torch.as_tensor(ref), torch.as_tensor(u2))
        want = jlt.sample_li(jscene, jnp.asarray(idx), jnp.asarray(ref), jnp.asarray(u2))
        assert (np.asarray(want.pdf) > 0).mean() > 0.4
        for k in ("wi", "li", "pdf", "p_target", "n_light", "is_delta"):
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                       rtol=1e-4, atol=1e-4, err_msg=f"light {light} {k}")


def material_scenes():
    """A scene of each ported lobe: Lambert, Oren-Nayar, mirror, and a black
    matte (no lobe), built by both packages' builders."""
    out = []
    for cls in (SceneBuilder, JaxBuilder):
        b = cls()
        b.add_matte(kd=(0.6, 0.5, 0.4))
        b.add_matte(kd=(0.3, 0.6, 0.2), sigma=25.0)
        b.add_mirror(kr=(0.9, 0.8, 0.7))
        b.add_matte(kd=(0.0, 0.0, 0.0))
        b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
        out.append(b.finalize("cpu") if cls is SceneBuilder else b.finalize())
    return out


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_bsdf():
    """make_bsdf_at, bsdf_f, bsdf_pdf and bsdf_sample per lane, for every
    lobe, over random local directions on both sides."""
    scene, jscene = material_scenes()
    rng = np.random.default_rng(5)
    n = 1000
    mat = rng.integers(0, 5, n).astype(np.int32)
    wo, wi = unit(rng, n), unit(rng, n)
    reflect = rng.uniform(size=n) < 0.8
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    uc = rng.uniform(size=n).astype(np.float32)
    b = bx.make_bsdf_at(scene, SimpleNamespace(mat=torch.as_tensor(mat)))
    jb = jbx.make_bsdf_at(jscene, SimpleNamespace(mat=jnp.asarray(mat), uv=jnp.zeros((n, 2)),
                                                  p=jnp.zeros((n, 3))))
    np.testing.assert_array_equal(b.kind0.numpy(), np.asarray(jb.kind0))
    np.testing.assert_array_equal(b.kind1.numpy(), np.asarray(jb.kind1))
    assert set(np.unique(b.kind0.numpy())) == {bx.LOBE_NONE, bx.LOBE_LAMBERT, bx.LOBE_ORENNAYAR,
                                               bx.LOBE_SPEC_REFL}
    targs = (torch.as_tensor(wo), torch.as_tensor(wi))
    jargs = (jnp.asarray(wo), jnp.asarray(wi))
    close = lambda g, w, what: np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                                         atol=1e-4, err_msg=what)
    close(bx.bsdf_f(b, *targs, torch.as_tensor(reflect)),
          jbx.bsdf_f(jb, *jargs, jnp.asarray(reflect)), "f")
    close(bx.bsdf_pdf(b, *targs), jbx.bsdf_pdf(jb, *jargs), "pdf")
    got = bx.bsdf_sample(b, targs[0], torch.as_tensor(u2), torch.as_tensor(uc))
    want = jbx.bsdf_sample(jb, jargs[0], jnp.asarray(u2), jnp.asarray(uc))
    for k in ("wi", "f", "pdf"):
        close(getattr(got, k), getattr(want, k), k)
    np.testing.assert_array_equal(got.is_specular.numpy(), np.asarray(want.is_specular))
    np.testing.assert_array_equal(got.is_transmission.numpy(), np.asarray(want.is_transmission))


def sample_ctx(jcamera, spp=SPP):
    """Both packages' sampler contexts of the whole grid at spp, and the JAX
    camera rays as numpy."""
    w, h = jcamera.resolution
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1))
    snum = np.repeat(np.arange(spp), w * h)
    jcfg = jsmpl.make_sampler(jsmpl.SOBOL, spp, (w, h))
    jctx = jsmpl.make_ctx(jcfg, jnp.asarray(pix, jnp.int32), jnp.asarray(snum, jnp.uint32),
                          frame_lt_spp=True)
    cfg = smpl.make_sampler(smpl.SOBOL, spp, (w, h))
    ctx = smpl.make_ctx(cfg, torch.as_tensor(pix), torch.as_tensor(snum), frame_lt_spp=True)
    u_film, u_time, u_lens = jsmpl.get_camera_dims(jcfg, jctx, jctx.pixel)
    rays = jcam.generate_rays(jcamera, jctx.pixel.astype(jnp.float32) + u_film, u_lens, u_time)
    return (jcfg, jctx), (cfg, ctx), np.asarray(rays.o), np.asarray(rays.d)


def test_get_1d_2d_bit_equal():
    """Film dims (remapped into the pixel) and integrator dims, one at a
    time and read from a block drawn ahead in one launch."""
    _, _, jcamera = scenes()
    (jcfg, jctx), (cfg, ctx), _, _ = sample_ctx(jcamera)
    blk = smpl.with_dims(cfg, ctx, 7, 9)
    for dim in (0, 1, 2, 5, 7, 12, 15, 40):
        want = np.asarray(jsmpl.get_1d(jcfg, jctx, dim))
        np.testing.assert_array_equal(smpl.get_1d(cfg, ctx, dim).numpy(), want)
        np.testing.assert_array_equal(smpl.get_1d(cfg, blk, dim).numpy(), want)
    np.testing.assert_array_equal(smpl.get_2d(cfg, blk, 10).numpy(),
                                  np.asarray(jsmpl.get_2d(jcfg, jctx, 10)))
    with pytest.raises(ValueError):
        smpl.with_dims(cfg, ctx, 1, 4)


INTEGRATORS = {
    "whitted": (lambda d: direct.WhittedCfg(d), direct.whitted_radiance,
                lambda d: jdirect.WhittedCfg(d), jdirect.whitted_radiance),
    "directlighting-all": (lambda d: direct.DirectLightingCfg(d, True),
                           direct.directlighting_radiance,
                           lambda d: jdirect.DirectLightingCfg(d, True),
                           jdirect.directlighting_radiance),
    "directlighting-one": (lambda d: direct.DirectLightingCfg(d, False),
                           direct.directlighting_radiance,
                           lambda d: jdirect.DirectLightingCfg(d, False),
                           jdirect.directlighting_radiance),
}


@pytest.mark.parametrize("name", sorted(INTEGRATORS))
def test_radiance_per_lane(name):
    """Per-lane radiance of the same camera rays and Sobol' samples."""
    scene, jscene, jcamera = scenes()
    (jcfg, jctx), (cfg, ctx), o, d = sample_ctx(jcamera)
    mk, fn, jmk, jfn = INTEGRATORS[name]
    want = np.asarray(jfn(jscene, jmk(DEPTH), jcfg, jctx, jnp.asarray(o), jnp.asarray(d)))
    got = fn(scene, mk(DEPTH), cfg, ctx, torch.as_tensor(o), torch.as_tensor(d)).numpy()
    assert np.isfinite(got).all() and want.mean() > 0.05
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("integrator", ["directlighting", "whitted"])
def test_render_matches_jax(integrator):
    scene, jscene, jcamera = scenes()
    camera = presets.spheres_direct(RES, device="cpu")[1]
    img = rdr.render(scene, camera, rdr.RenderCfg(integrator, SPP, DEPTH, 1.0),
                     smpl.make_sampler(smpl.SOBOL, SPP, RES)).numpy()
    want = np.asarray(jrdr.render(jscene, jcamera, jrdr.RenderCfg(integrator, spp=SPP,
                                                                 max_depth=DEPTH,
                                                                 rr_threshold=1.0),
                                  jsmpl.make_sampler(jsmpl.SOBOL, SPP, RES)))
    assert img.shape == want.shape == (RES[1], RES[0], 3) and want.mean() > 0.05
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name,max_depth", [("whitted", 2), ("directlighting-all", 3),
                                            ("directlighting-one", 1)])
def test_launch_sequence_matches_jax(name, max_depth, monkeypatch):
    """The port's loop launches K5 and K4 where the JAX loop on the TPU
    launches pallas_intersect_tris_full and pallas_intersect_tris_p, and
    reads the same Sobol' dims in the same order; each depth's dims come
    from one K1 launch made just after that depth's K5.  The sweeps are
    replaced by recorders that report misses, so nothing is traced."""
    scene, jscene, jcamera = scenes()
    (jcfg, jctx), (cfg, ctx), o, d = sample_ctx(jcamera, spp=1)
    n = o.shape[0]
    seen_j, seen = [], []

    def jfull(o_, d_, t_max, tri_attr, n_tri):
        seen_j.append("K5")
        z3 = jnp.zeros((n, 3))
        return dict(valid=jnp.zeros(n, bool), t=t_max, prim=jnp.full(n, -1, jnp.int32), p=z3,
                    p_err=z3, ng=z3, ns=z3, uv=jnp.zeros((n, 2)), dpdu=z3,
                    mat=jnp.zeros(n, jnp.int32), light=jnp.full(n, -1, jnp.int32))

    def jany(*_):
        seen_j.append("K4")
        return jnp.zeros(n, bool)

    jget_1d = jsmpl.get_1d
    monkeypatch.setattr(jsi, "_use_pallas", lambda: True)
    monkeypatch.setattr(jpin, "pallas_intersect_tris_full", jfull)
    monkeypatch.setattr(jpin, "pallas_intersect_tris_p", jany)
    monkeypatch.setattr(jsmpl, "get_1d", lambda c, x, dim: seen_j.append(dim) or jget_1d(c, x, dim))

    def full(o_, d_, t_max, tris, n_tri):
        seen.append("K5")
        rows = torch.zeros((ik.N_F_ROWS, n))
        rows[ik.F_T] = t_max
        ids = torch.tensor([[-1], [0], [-1]], dtype=torch.int32).expand(3, n)
        return ik.FullHit(rows, ids)

    def any_(*_):
        seen.append("K4")
        return torch.zeros(n, dtype=torch.bool)

    get_1d, sobol_dims = smpl.get_1d, sk.sobol_dims
    blocks = []
    monkeypatch.setattr(ik, "full_sweep", full)
    monkeypatch.setattr(ik, "any_sweep", any_)
    monkeypatch.setattr(smpl, "get_1d", lambda c, x, dim: seen.append(dim) or get_1d(c, x, dim))
    monkeypatch.setattr(sk, "sobol_dims", lambda idx, dim0, n_dims, bits: blocks.append(
        (len(seen), dim0, n_dims)) or sobol_dims(idx, dim0, n_dims, bits))

    mk, fn, jmk, jfn = INTEGRATORS[name]
    jfn(jscene, jmk(max_depth), jcfg, jctx, jnp.asarray(o), jnp.asarray(d))
    fn(scene, mk(max_depth), cfg, ctx, torch.as_tensor(o), torch.as_tensor(d))
    assert seen == seen_j
    n_l = scene.n_lights
    assert seen.count("K5") == max_depth
    assert seen.count("K4") == max_depth * (n_l if name != "directlighting-one" else 1)
    stride = direct.dims_per_depth(scene)
    k5_at = [i for i, e in enumerate(seen) if e == "K5"]
    assert blocks == [(k5_at[k] + 1, direct.DIM_CAMERA + k * stride, stride)
                      for k in range(max_depth)]
    ends = k5_at[1:] + [len(seen)]
    for k in range(max_depth):  # every dim of depth k lies in its block
        dims = [e for e in seen[k5_at[k]:ends[k]] if isinstance(e, int)]
        assert dims and all(0 <= x - (direct.DIM_CAMERA + k * stride) < stride for x in dims)


def test_render_launches_k1_once_per_depth(monkeypatch):
    """A render draws its camera dims and then each depth's integrator dims
    in one K1 launch each: 1 + max_depth launches."""
    scene, camera = presets.spheres_direct((4, 4), device="cpu")
    calls = []
    sobol_dims = sk.sobol_dims
    monkeypatch.setattr(sk, "sobol_dims", lambda *a: calls.append(a[1:3]) or sobol_dims(*a))
    rdr.render(scene, camera, rdr.RenderCfg("whitted", 1, DEPTH, 1.0),
               smpl.make_sampler(smpl.SOBOL, 1, (4, 4)))
    stride = direct.dims_per_depth(scene)
    assert calls == [(0, 5)] + [(5 + k * stride, stride) for k in range(DEPTH)]


def test_unported_parts_raise():
    """A goniometric light's tag in the mask no longer raises (the image
    is unchanged where no light has it).  A crop window and spatial light
    selection render: the crop's pixels are the whole film's, and the
    direct integrators select lights as they do without spatial selection,
    as in the JAX package."""
    scene, camera = presets.spheres_direct((4, 4), device="cpu")
    scfg = smpl.make_sampler(smpl.SOBOL, 1, (4, 4))
    before = rdr.render(scene, camera, rdr.RenderCfg("whitted", 1, 1, 1.0), scfg)
    scene.light_type_mask |= 1 << sa.LIGHT_GONIO
    assert torch.equal(rdr.render(scene, camera, rdr.RenderCfg("whitted", 1, 1, 1.0), scfg),
                       before)
    scene.light_type_mask &= ~(1 << sa.LIGHT_GONIO)
    for cfg, same in ((rdr.RenderCfg("whitted", 1, 1, 1.0, crop=(0, .5, 0, 1)), np.s_[0:4, 0:2]),
                      (rdr.RenderCfg("directlighting", 1, 1, 1.0, light_strategy="spatial"),
                       np.s_[:, :])):
        img = rdr.render(scene, camera, cfg, scfg).numpy()
        whole = rdr.render(scene, camera, cfg._replace(crop=None, light_strategy="power"),
                           scfg).numpy()
        assert img[same].mean() > 0
        np.testing.assert_array_equal(img[same], whole[same])
        assert img.sum() == img[same].sum()
    # a projection light and textured parameters render now (no raise)
    b = JaxBuilder()
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    b.add_projection_light(p=(0, 0, 1), to=(0, 0, 0))
    img = rdr.render(bridge(b.finalize()), camera, rdr.RenderCfg("whitted", 1, 1, 1.0), scfg)
    assert torch.isfinite(img).all()
    b = JaxBuilder()
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=b.add_plastic())
    plastic = bridge(b.finalize())
    untextured = rdr.render(plastic, camera, rdr.RenderCfg("directlighting", 1, 1, 1.0), scfg)
    plastic.tex_slot_mask = 1  # no slot holds a texture: the same image
    assert torch.equal(
        rdr.render(plastic, camera, rdr.RenderCfg("directlighting", 1, 1, 1.0), scfg),
        untextured)
