"""rs_pbrt_tpu_torch's glass (ops/bsdf.py: FresnelSpecular when smooth,
TrowbridgeReitz microfacet reflection and transmission when rough), the
path integrator's eta_scale (fixed-depth loop and regeneration) and the
direct integrators' specular transmission, against the JAX package on the
same inputs.

Tolerances: the lobes' f, pdf and samples on 4,096 seeded directions rtol
1e-4 (atol 1e-6; the same formulas, float association and XLA's fused
multiply-adds differ in ulps); the white furnace as
tests/test_furnace_bxdf.py holds the JAX lobes (smooth glass's albedo F +
(1 - F) / eta^2 within 0.02, rough glass's within (0.3, 1.1)); the renders
of the caustic scene's geometry per pixel rtol = atol = 2e-3, against JAX
renders made without FMA contraction (tests/_caustic.py says why), the
path integrator's against the means of the JAX package's per-lane
radiance, which the port's radiance on the same rays also meets lane by
lane at 2e-3 (tests/_caustic.py: the JAX jitted render rounds its camera
rays otherwise, and then one lane of 4,096 flips Russian roulette); the
regeneration loop per path rtol 1e-5, atol 1e-6 of the fixed-depth loop
(tests/test_regen.py:57).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _caustic
from rs_pbrt_tpu.ops import bsdf as jbx
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import regen
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import bsdf as bx
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import caustic_scenes

torch.set_num_threads(2)

N_DIRS = 4096
RES, SPP = 32, 4


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _glass_params(rng, n, rough: bool):
    """Glass rows: colored kr and kt, eta in [1.2, 2], and where rough,
    anisotropic roughness, remapped on half the lanes."""
    p = np.zeros((n, sa.N_MAT_PARAMS), np.float32)
    p[:, sa.MP_KR:sa.MP_KR + 3] = rng.uniform(0.3, 1.0, (n, 3))
    p[:, sa.MP_KT:sa.MP_KT + 3] = rng.uniform(0.3, 1.0, (n, 3))
    p[:, sa.MP_ETA] = rng.uniform(1.2, 2.0, n)
    if rough:
        p[:, sa.MP_ROUGH_U] = rng.uniform(0.05, 0.6, n)
        p[:, sa.MP_ROUGH_V] = rng.uniform(0.05, 0.6, n)
        p[:, sa.MP_REMAP_ROUGH] = rng.uniform(size=n) < 0.5
    return np.full(n, sa.GLASS, np.int32), p


@pytest.fixture(scope="module", params=["smooth", "rough"])
def lobes(request):
    rng = np.random.default_rng(11 if request.param == "smooth" else 12)
    mt, p = _glass_params(rng, N_DIRS, request.param == "rough")
    b = bx.make_bsdf(torch.as_tensor(mt), torch.as_tensor(p))
    jb = jbx.make_bsdf(jnp.asarray(mt), jnp.asarray(p), mat_mask=1 << sa.GLASS)
    wo, wi = _unit(rng, N_DIRS), _unit(rng, N_DIRS)
    u2 = rng.uniform(size=(N_DIRS, 2)).astype(np.float32)
    uc = rng.uniform(size=N_DIRS).astype(np.float32)
    return request.param, b, jb, wo, wi, u2, uc


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-6,
                               err_msg=what)


def test_make_bsdf_glass(lobes):
    kind, b, jb, *_ = lobes
    for k in ("kind0", "kind1", "r0", "r1", "eta"):
        close(getattr(b, k).numpy(), getattr(jb, k), k)
    close(b.kt.numpy(), jb.kt, "kt")
    if kind == "smooth":
        assert (b.kind0 == bx.LOBE_FRESNEL_SPEC).all() and (b.kind1 == bx.LOBE_NONE).all()
        assert not bx.has_nonspecular(b).any()
    else:
        assert (b.kind0 == bx.LOBE_MICROFACET_REFL).all()
        assert (b.kind1 == bx.LOBE_MICROFACET_TRANS).all()
        close(b.ax.numpy(), jb.ax, "ax")
        close(b.ay.numpy(), jb.ay, "ay")
        assert bx.has_nonspecular(b).all()


def test_glass_f_pdf_sample(lobes):
    kind, b, jb, wo, wi, u2, uc = lobes
    for reflect in (True, False):
        flag = np.full(N_DIRS, reflect)
        close(bx.bsdf_f(b, torch.as_tensor(wo), torch.as_tensor(wi), torch.as_tensor(flag)),
              jbx.bsdf_f(jb, jnp.asarray(wo), jnp.asarray(wi), jnp.asarray(flag)),
              f"{kind} f, reflect {reflect}")
    close(bx.bsdf_pdf(b, torch.as_tensor(wo), torch.as_tensor(wi)),
          jbx.bsdf_pdf(jb, jnp.asarray(wo), jnp.asarray(wi)), f"{kind} pdf")
    s = bx.bsdf_sample(b, torch.as_tensor(wo), torch.as_tensor(u2), torch.as_tensor(uc))
    js = jbx.bsdf_sample(jb, jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(uc))
    for k in ("is_specular", "is_transmission"):
        np.testing.assert_array_equal(getattr(s, k).numpy(), np.asarray(getattr(js, k)), k)
    live = np.asarray(js.pdf) > 0
    np.testing.assert_array_equal(s.pdf.numpy() > 0, live)
    close(s.wi.numpy()[live], np.asarray(js.wi)[live], f"{kind} sampled wi")
    close(s.pdf.numpy(), js.pdf, f"{kind} sampled pdf")
    close(s.f.numpy(), js.f, f"{kind} sampled f")
    # both branches of each lobe are drawn
    assert 0 < int(s.is_transmission.sum()) < N_DIRS


def _albedo(rough: float, wo=(0.3, 0.1, 0.95), n=8192, seed=0):
    """tests/test_furnace_bxdf.py's estimate of rho(wo) by BSDF sampling,
    white glass of index 1.5."""
    bld = SceneBuilder()
    mat = bld.add_glass(kr=(1, 1, 1), kt=(1, 1, 1), eta=1.5, roughness=rough)
    bld.add_sphere(radius=1.0, material=mat)
    scene = bld.finalize("cpu")
    rs = np.random.RandomState(seed)
    b = bx.make_bsdf_from_mat(scene, torch.full((n,), mat, dtype=torch.int32))
    wo = torch.as_tensor(np.asarray(wo, np.float32) / np.linalg.norm(wo)).expand(n, 3)
    u2 = torch.as_tensor(rs.uniform(size=(n, 2)).astype(np.float32))
    uc = torch.as_tensor(rs.uniform(size=n).astype(np.float32))
    s = bx.bsdf_sample(b, wo, u2, uc)
    w = s.f * s.wi[:, 2:3].abs() / torch.clamp(s.pdf, min=1e-12)[:, None]
    return torch.where((s.pdf > 0)[:, None], w, 0.0).mean(0).numpy()


def test_furnace_smooth_glass_exact():
    eta, wo = 1.5, np.asarray([0.3, 0.1, 0.95], np.float32)
    f = float(bx.fr_dielectric(torch.tensor(wo[2] / np.linalg.norm(wo)), torch.tensor(1.0),
                               torch.tensor(eta)))
    np.testing.assert_allclose(_albedo(0.0), f + (1.0 - f) / eta ** 2, atol=0.02)


def test_furnace_rough_glass_bounded():
    a = _albedo(0.2)
    assert (a < 1.1).all() and (a > 0.3).all(), a


def _texts():
    direct = _caustic.scene_text("caustic_only", RES, integrator="directlighting", spp=SPP,
                                 sampler="sobol")
    return {
        "path": _caustic.scene_text("caustic_only", RES, integrator="path", sampler="sobol",
                                    spp=SPP),
        "whitted": _caustic.scene_text("caustic_only", RES, integrator="whitted",
                                       sampler="sobol", spp=SPP),
        # one light picked by power (integrator.rs:359), where "all" would
        # give whitted's image here
        "directlighting": direct.replace('"directlighting"',
                                         '"directlighting" "string strategy" "one"'),
    }


@pytest.fixture(scope="module")
def jax_images(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("glass")
    texts = _texts()
    jobs = {k: (t, None) for k, t in texts.items() if k != "path"}
    jobs["lanes_path"] = (texts["path"], None)
    return _caustic.jax_renders(jobs, tmp)


@pytest.mark.parametrize("integrator", ["path", "whitted", "directlighting"])
def test_glass_render_matches_jax(integrator, jax_images, tmp_path):
    """The caustic scene's geometry (a smooth glass sphere over a matte
    floor, two point lights) at 32x32, 4 spp, depth 5, Sobol'; path with
    the file's spatial light selection."""
    got = _caustic.port_render(_texts()[integrator], tmp_path, integrator)
    if integrator == "path":
        want = jax_images["lanes_path"].reshape(SPP, RES, RES, 3).mean(0)
    else:
        want = jax_images[integrator]
    assert got.shape == want.shape == (RES, RES, 3) and np.isfinite(got).all()
    assert want.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_glass_path_radiance_matches_jax(jax_images, tmp_path):
    """The path integrator's radiance lane by lane on the JAX camera rays."""
    from rs_pbrt_tpu_torch.models import lightdistrib

    scene, camera, cfg, scfg, _ = _caustic.port_inputs(
        *_caustic.parse(_texts()["path"], tmp_path, "lanes"))
    assert cfg.light_strategy == "spatial"
    ctx, _ = rdr.camera_rays(camera, scfg, 0, SPP)
    got = pathmod.radiance(scene, pathmod.PathCfg(cfg.max_depth, cfg.rr_threshold), scfg, ctx,
                           torch.as_tensor(jax_images["lanes_path:o"]),
                           torch.as_tensor(jax_images["lanes_path:d"]),
                           light_distrib=lightdistrib.build_spatial(scene)).numpy()
    want = jax_images["lanes_path"]
    assert want.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_eta_scale_in_regeneration():
    """The regeneration loop carries eta_scale and resets it for a new path:
    per path equal to the fixed-depth loop on the caustic scene, whose
    paths refract through the sphere before Russian roulette starts."""
    scene, camera = caustic_scenes.caustic_only((16, 16), device="cpu")
    pcfg = pathmod.PathCfg(5, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, SPP, camera.resolution)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, SPP)
    st = {}
    got = regen.radiance_regen(scene, pcfg, scfg, ctx, rays.o, rays.d, None, lane_width=64,
                               stats=st)
    want = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d)
    assert st["iterations"] > 6 and float(want.mean()) > 0.01
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_eta_scale_scales_russian_roulette(monkeypatch):
    """Russian roulette reads beta * eta_scale: with eta_scale left at 1
    (every path's factor replaced by 1) the caustic render changes, so the
    factor is live on these paths."""
    scene, camera = caustic_scenes.caustic_only((16, 16), device="cpu")
    pcfg = pathmod.PathCfg(5, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, SPP, camera.resolution)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, SPP)
    want = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d)
    shade = pathmod._shade_and_extend

    def without_eta(*a):
        out = shade(*a)
        return out[:-1] + (torch.ones_like(out[-1]),)

    monkeypatch.setattr(pathmod, "_shade_and_extend", without_eta)
    got = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d)
    assert not torch.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_microfacet_gate_without_rough_glass(tmp_path):
    """A scene without rough glass skips the microfacet math
    (Scene.has_rough_glass False, from the builder and from the bridge):
    smooth glass and Lambert lanes give the same f, pdf and samples either
    way."""
    scene, _ = caustic_scenes.caustic_only((8, 8), device="cpu")
    assert not scene.has_rough_glass and scene.mat_kind_mask & (1 << sa.GLASS)
    bridged = _caustic.port_inputs(*_caustic.parse(_caustic.scene_text("caustic_only", 8),
                                                   tmp_path, "gate"))[0]
    assert not bridged.has_rough_glass
    bld = SceneBuilder()
    bld.add_sphere(radius=1.0, material=bld.add_glass(roughness=0.1))
    assert bld.finalize("cpu").has_rough_glass
    rng = np.random.default_rng(4)
    n = 2048
    ma = scene.mat_attr[torch.as_tensor(rng.integers(0, scene.mat_attr.shape[0], n))]
    args = (torch.round(ma[:, sa.MA_TYPE]).to(torch.int32),
            ma[:, sa.MA_PARAMS:sa.MA_PARAMS + sa.N_MAT_PARAMS])
    gated, full = bx.make_bsdf(*args, enable_microfacet=False), bx.make_bsdf(*args)
    mf = 1 << bx.LOBE_MICROFACET_REFL
    assert not gated.lobe_mask & mf and full.lobe_mask & mf
    wo, wi = torch.as_tensor(_unit(rng, n)), torch.as_tensor(_unit(rng, n))
    u2 = torch.as_tensor(rng.uniform(size=(n, 2)).astype(np.float32))
    uc = torch.as_tensor(rng.uniform(size=n).astype(np.float32))
    flag = torch.as_tensor(rng.uniform(size=n) < 0.5)
    assert torch.equal(bx.bsdf_f(gated, wo, wi, flag), bx.bsdf_f(full, wo, wi, flag))
    assert torch.equal(bx.bsdf_pdf(gated, wo, wi), bx.bsdf_pdf(full, wo, wi))
    for a, b in zip(bx.bsdf_sample(gated, wo, u2, uc), bx.bsdf_sample(full, wo, u2, uc)):
        assert torch.equal(a, b)
