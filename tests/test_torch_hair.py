"""rs_pbrt_tpu_torch's hair: the hair BSDF (ops/bsdf.py), the hair_patch
showcase scene (tools/hair_scenes.py) and its self-golden, and path
regeneration through a curve tree, against the JAX package on the same
inputs.

Tolerances: hair_f, hair_pdf and hair_sample on 50,000 directions rtol
1e-4, atol 1e-6 (the same formulas; exp, log, sinh, atan2 and asin of two
libraries and float association differ in ulps, which Mp's exp of
differences of terms up to 1/v amplifies), and so are bsdf_f, bsdf_pdf
and bsdf_sample, but for bsdf_sample's f at sampled directions within
1e-2 of grazing, rtol 5e-3 (f divides by |cos theta_i|); the hair_patch tables allclose
1e-6 (test_torch_scene.py's) and the curve rows bit-equal; the renders
against the self-golden tests/goldens/self/hair_patch.npz and against the
JAX render in this process with test_self_goldens.py's own limits (mean
absolute error below 5e-3 of the image's maximum, under 1% of the pixels
off by more than 5e-2 of it: curve silhouettes are knife edges); the
regeneration loop per path rtol 1e-5, atol 1e-6 of the fixed-depth loop
(tests/test_regen.py:57).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models.integrators import render as jrdr
from rs_pbrt_tpu.ops import bsdf as jbx
from rs_pbrt_tpu.ops.scene_intersect import build_accel as jbuild_accel
from rs_pbrt_tpu.scene.api import load_pbrt
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import regen
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import bsdf as bx
from rs_pbrt_tpu_torch.ops import film as filmmod
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.tools import hair_scenes
from test_torch_scene import assert_tables_equal, bridge

import _selfgolden as sg

torch.set_num_threads(2)

N_DIRS = 50000


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _hair_params(rng, n):
    """Hair material rows: sigma_a or a color (mode 1), beta_m, beta_n,
    alpha and eta varied per lane, and the hits' uv."""
    p = np.zeros((n, sa.N_MAT_PARAMS), np.float32)
    p[:, sa.MP_KD:sa.MP_KD + 3] = rng.uniform(0.0, 1.0, (n, 3))
    p[:, sa.MP_HAIR_BETA_M] = rng.uniform(0.2, 0.8, n)
    p[:, sa.MP_HAIR_BETA_N] = rng.uniform(0.2, 0.8, n)
    p[:, sa.MP_HAIR_ALPHA] = rng.uniform(0.0, 4.0, n)
    p[:, sa.MP_ETA] = 1.55
    p[:, sa.MP_HAIR_MODE] = (rng.uniform(size=n) < 0.5).astype(np.float32)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    return np.full(n, sa.HAIR, np.int32), p, uv


@pytest.fixture(scope="module")
def lobes():
    rng = np.random.default_rng(7)
    mt, p, uv = _hair_params(rng, N_DIRS)
    b = bx.make_bsdf(torch.as_tensor(mt), torch.as_tensor(p), torch.as_tensor(uv))
    jb = jbx.make_bsdf(jnp.asarray(mt), jnp.asarray(p), uv=jnp.asarray(uv))
    wo, wi = _unit(rng, N_DIRS), _unit(rng, N_DIRS)
    u2 = rng.uniform(size=(N_DIRS, 2)).astype(np.float32)
    return b, jb, wo, wi, u2


def close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6, err_msg=what)


def test_make_bsdf_hair(lobes):
    b, jb, _, _, _ = lobes
    assert (b.kind0 == bx.LOBE_HAIR).all() and int(jbx.LOBE_HAIR) == bx.LOBE_HAIR
    for k in ("r0", "ax", "ay", "eta", "h", "sigma"):
        close(getattr(b, k), getattr(jb, k), k)


def test_hair_f_pdf_sample(lobes):
    b, jb, wo, wi, u2 = lobes
    two = lambda x: (torch.as_tensor(x), jnp.asarray(x))
    (wo_t, wo_j), (wi_t, wi_j), (u_t, u_j) = two(wo), two(wi), two(u2)
    f, jf = bx.hair_f(b, wo_t, wi_t), jbx.hair_f(jb, wo_j, wi_j)
    assert float(f.mean()) > 0.01
    close(f, jf, "hair_f")
    close(bx.hair_pdf(b, wo_t, wi_t), jbx.hair_pdf(jb, wo_j, wi_j), "hair_pdf")
    wi_s, pdf_s = bx.hair_sample(b, wo_t, u_t)
    jwi_s, jpdf_s = jbx.hair_sample(jb, wo_j, u_j)
    close(wi_s, jwi_s, "hair_sample wi")
    close(pdf_s, jpdf_s, "hair_sample pdf")
    # the Bsdf's own entry points: the lobe over the whole sphere
    reflect = torch.as_tensor(np.random.default_rng(1).uniform(size=N_DIRS) < 0.5)
    close(bx.bsdf_f(b, wo_t, wi_t, reflect), jbx.bsdf_f(jb, wo_j, wi_j, jnp.asarray(
        reflect.numpy())), "bsdf_f")
    close(bx.bsdf_pdf(b, wo_t, wi_t), jbx.bsdf_pdf(jb, wo_j, wi_j), "bsdf_pdf")
    uc = np.random.default_rng(2).uniform(size=N_DIRS).astype(np.float32)
    bs = bx.bsdf_sample(b, wo_t, u_t, torch.as_tensor(uc))
    jbs = jbx.bsdf_sample(jb, wo_j, u_j, jnp.asarray(uc))
    for k in ("wi", "pdf"):
        close(getattr(bs, k), getattr(jbs, k), f"bsdf_sample {k}")
    # f divides by |cos theta_i| of the sampled direction: where that is
    # below 1e-2, the sample's differences (4e-6) reach 2e-3 of f
    graze = bs.wi[:, 2].abs() < 1e-2
    close(bs.f[~graze], np.asarray(jbs.f)[~graze.numpy()], "bsdf_sample f")
    np.testing.assert_allclose(bs.f[graze].numpy(), np.asarray(jbs.f)[graze.numpy()], rtol=5e-3,
                               atol=1e-6, err_msg="bsdf_sample f, grazing")
    assert not bs.is_specular.any() and not bs.is_transmission.any()


def test_demux_float_bit_equal():
    """The int64 de-interleave gives the JAX uint32 one's values."""
    u = np.concatenate([np.random.default_rng(3).uniform(size=4000), [0.0, 0.5, 0.99999994,
                                                                      1.0]]).astype(np.float32)
    a, b = bx._demux_float(torch.as_tensor(u))
    ja, jb_ = jbx._demux_float(jnp.asarray(u))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb_))


def _parse_hair_patch(tmp_path, res, spp):
    """The JAX front end's hair_patch.pbrt at res x res, spp (as
    tests/_selfgolden.py renders it): (scene, camera, cfg, scfg, fcfg)."""
    fname, _, _, _ = sg.CONFIGS["hair_patch"]
    txt = open(os.path.join(sg.SCENES, fname)).read()
    txt = txt.replace('"integer xresolution" 200', f'"integer xresolution" {res}')
    txt = txt.replace('"integer yresolution" 200', f'"integer yresolution" {res}')
    path = tmp_path / "hair_patch.pbrt"
    path.write_text(txt)
    return load_pbrt(str(path), {"samples": spp})[:5]


def _port_render(jscene, jcamera, jcfg, jfcfg, spp, res):
    """The port's render on the CPU of the bridged JAX scene and camera."""
    scene = bridge(jscene)
    camera = cam.camera_from_numpy({f.name: getattr(jcamera, f.name)
                                    for f in dataclasses.fields(jcamera)}, device="cpu")
    cfg = rdr.RenderCfg(jcfg.integrator, jcfg.spp, jcfg.max_depth, jcfg.rr_threshold,
                        light_strategy=jcfg.light_strategy)
    fcfg = filmmod.FilterCfg(jfcfg.kind, jfcfg.xwidth, jfcfg.ywidth)
    return rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, spp, (res, res)), fcfg,
                      accel=si.build_accel(scene, device="cpu")).numpy().astype(np.float64)


def _self_golden_limits(got, want, name):
    """test_self_goldens.py's _check."""
    err = np.abs(got - want)
    scale = max(float(want.max()), 1e-3)
    assert err.mean() / scale < 5e-3, f"{name} mae {err.mean():.5f} (scale {scale:.3f})"
    frac_bad = float((err.max(-1) / scale > 5e-2).mean())
    assert frac_bad < 0.01, f"{name} outlier pixels {frac_bad:.3%}"


def test_hair_scene_tables_equal_parsed_file(tmp_path):
    """tools.hair_scenes.hair_patch builds the tables of the parsed file, and
    its camera is the file's."""
    jscene, jcamera, jcfg, jscfg, _ = _parse_hair_patch(tmp_path, 200, 16)
    scene, camera = hair_scenes.hair_patch(device="cpu")
    assert_tables_equal(scene, jscene)
    np.testing.assert_array_equal(scene.crv_attr.numpy(), np.asarray(jscene.crv_attr))
    assert scene.n_curve_segs == 48 and scene.has_hair and jscene.has_hair
    assert scene.light_type_mask == 1 << sa.LIGHT_POINT
    want = cam.camera_from_numpy({f.name: getattr(jcamera, f.name)
                                  for f in dataclasses.fields(jcamera)}, device="cpu")
    assert camera.resolution == want.resolution == (200, 200)
    for f in dataclasses.fields(want):
        a, b = getattr(camera, f.name), getattr(want, f.name)
        if torch.is_tensor(b):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f.name)
    cfg = hair_scenes.CFG
    assert (cfg.integrator, cfg.spp, cfg.max_depth) == (jcfg.integrator, jscfg.spp,
                                                       jcfg.max_depth) == ("path", 16, 5)


def test_hair_patch_self_golden(tmp_path):
    """The port's render of the parsed file (48x48, 4 spp, as
    tests/_selfgolden.py renders it) held to the JAX package's committed
    golden."""
    jscene, jcamera, jcfg, _, jfcfg = _parse_hair_patch(tmp_path, 48, 4)
    got = _port_render(jscene, jcamera, jcfg, jfcfg, 4, 48)
    want = np.load(sg.golden_path("hair_patch"))["img"].astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    _self_golden_limits(got, want, "hair_patch")


def test_hair_patch_matches_jax_render(tmp_path):
    jscene, jcamera, jcfg, jscfg, jfcfg = _parse_hair_patch(tmp_path, 16, 2)
    got = _port_render(jscene, jcamera, jcfg, jfcfg, 2, 16)
    want = np.asarray(jrdr.render(jscene, jcamera, jcfg, jscfg, jfcfg,
                                  accel=jbuild_accel(jscene, kind="bvh")), np.float64)
    assert want.mean() > 0.01
    _self_golden_limits(got, want, "hair_patch 16x16")


def test_regen_through_the_curve_tree():
    """A 64-fibre patch (2,048 segments, walked through its tree): the
    regeneration loop per path equal to the fixed-depth loop, and render
    takes regeneration for it."""
    res, spp = (8, 8), 4
    scene, camera = hair_scenes.fur_patch(64, resolution=res, device="cpu")
    accel = si.build_accel(scene, device="cpu")
    assert si.uses_curve_bvh(scene, accel) and not si.uses_bvh(scene, accel)
    pcfg = pathmod.PathCfg(5, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, spp, res)
    assert regen.eligible(scene, pcfg, scfg, accel, 256, lane_width=64)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, spp)
    st = {}
    got = regen.radiance_regen(scene, pcfg, scfg, ctx, rays.o, rays.d, accel, lane_width=64,
                               stats=st)
    want = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, accel)
    assert st["iterations"] > 6 and float(want.mean()) > 0.01
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
