"""rs_pbrt_tpu_torch's SPPM (models/integrators/sppm.py), its photon
emission (models/lights.sample_le) and S1's plain version
(ops/sppm_kernel.deposit_plain) against the JAX package on the same
inputs, its caustic scenes (tools/caustic_scenes.py) against the parsed
files, and its render of BASELINE config 5's caustic scene against the JAX
render and the JAX package's self-golden.

Tolerances: sample_le rtol 1e-5 (atol 1e-6); the grid (order, w_scale,
res, overflow) equal; the deposit's phi rtol 1e-5 (atol 1e-6; the BSDF's
float association differs in ulps) on the VPs of Lambert and Oren-Nayar
lobes, rtol 1e-4 on those of the hair lobe (test_torch_hair.py's bound on
the lobe itself: exp of differences of terms up to 1/v amplifies the
ulps), and m equal (the same events are near); the caustic scene's tables allclose 1e-6 (test_torch_scene.py's)
and its curve rows bit-equal; the render at 24x24, 2 iterations, depth 3
per pixel rtol = atol = 2e-3 against the JAX render made without FMA
contraction (tests/_caustic.py), its bucket overflow and grid resolution
equal; the 48x48 render of tests/_selfgolden.py's caustic_sppm within
tests/test_self_goldens.py's limits (mean absolute error below 5e-3 of the
image's maximum, under 1% of the pixels off by more than 5e-2 of it).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _caustic
import _selfgolden as sg
from rs_pbrt_tpu.models import lights as jlt
from rs_pbrt_tpu.models.integrators import sppm as jsppm
from rs_pbrt_tpu.scene.api import load_pbrt
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import lights as lt
from rs_pbrt_tpu_torch.models.integrators import sppm
from rs_pbrt_tpu_torch.ops import sppm_kernel as sk
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import caustic_scenes
from rs_pbrt_tpu_torch.utils import transform as tr
from test_torch_scene import assert_tables_equal, bridge

torch.set_num_threads(2)

N_LE = 4096


def build_lights(cls):
    """Every light sample_le emits from: point, spot, distant, an area
    light on two triangles of unequal area and one on a sphere."""
    xf = jtr if cls is JaxBuilder else tr
    b = cls()
    m = b.add_matte(kd=(0.5, 0.5, 0.5))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        np.asarray([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32),
                        material=m)
    b.add_triangle_mesh([[0, 1, 2], [1, 3, 2]],
                        np.asarray([[-1, 3, -1], [1, 3, -1], [-1, 3, 0.5], [0.5, 3.2, 2]],
                                   np.float32), material=m,
                        area_light=dict(L=(4.0, 4.0, 3.0), two_sided=False))
    b.add_sphere(xf.translate([1.5, 1.0, 0.5]), radius=0.3, material=m,
                 area_light=dict(L=(2.0, 3.0, 4.0)))
    b.add_point_light(p=(-2.0, 3.0, 2.0), I=(6.0, 5.0, 4.0))
    b.add_spot_light(p=(0.5, 3.0, 0.5), to=(0.0, 0.0, 0.0), I=(20.0, 20.0, 24.0),
                     cone_angle=30.0, cone_delta=5.0)
    b.add_distant_light(from_p=(1.0, 2.0, 1.5), to=(0, 0, 0), L=(0.8, 0.7, 0.6))
    return b.finalize("cpu") if cls is SceneBuilder else b.finalize()


def test_sample_le_matches_jax():
    scene, jscene = build_lights(SceneBuilder), build_lights(JaxBuilder)
    assert_tables_equal(scene, jscene)
    rng = np.random.default_rng(3)
    idx = np.tile(np.arange(scene.n_lights, dtype=np.int32), N_LE // scene.n_lights + 1)[:N_LE]
    u_pos = rng.uniform(size=(N_LE, 2)).astype(np.float32)
    u_dir = rng.uniform(size=(N_LE, 2)).astype(np.float32)
    got = lt.sample_le(scene, torch.as_tensor(idx), torch.as_tensor(u_pos),
                       torch.as_tensor(u_dir))
    want = jlt.sample_le(jscene, jnp.asarray(idx), jnp.asarray(u_pos), jnp.asarray(u_dir))
    for k in got._fields:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert scene.n_lights == 5 and (got.pdf_dir > 0).all()


def _vps_events(rng, n_vp=600, n_ev=3000, mats=(1, 2, 3)):
    """VPs and photon events in the unit box, a fifth of each crowded into
    a small cluster (whose buckets run deeper than the scan), some VPs and
    events invalid: (JAX VisiblePoints, port VisiblePoints, radius, (ev_p,
    ev_wi, ev_beta, ev_ok))."""
    def pts(n):
        p = rng.uniform(0, 1, (n, 3))
        c = rng.uniform(size=n) < 0.2
        p[c] = 0.5 + rng.uniform(-0.004, 0.004, (int(c.sum()), 3))
        return p.astype(np.float32)

    def unit(n):
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    f = dict(p=pts(n_vp), wo=unit(n_vp), ns=unit(n_vp),
             beta=rng.uniform(0.2, 1.0, (n_vp, 3)).astype(np.float32),
             mat=rng.choice(np.asarray(mats, np.int32), n_vp),
             valid=rng.uniform(size=n_vp) < 0.9)
    radius = rng.uniform(0.03, 0.08, n_vp).astype(np.float32)
    ev = (pts(n_ev), unit(n_ev), rng.uniform(0.0, 2.0, (n_ev, 3)).astype(np.float32),
          rng.uniform(size=n_ev) < 0.9)
    jv = jsppm.VisiblePoints(**{k: jnp.asarray(v) for k, v in f.items()})
    tv = sppm.VisiblePoints(**{k: torch.as_tensor(v) for k, v in f.items()})
    return jv, tv, radius, ev


@pytest.fixture(scope="module")
def deposit_scene():
    """A JAX scene with a Lambert, an Oren-Nayar and a hair material (ids
    1-3), bridged into the port."""
    b = JaxBuilder()
    b.add_matte(kd=(0.6, 0.5, 0.4))
    b.add_matte(kd=(0.5, 0.5, 0.7), sigma=20.0)
    b.add_hair(eumelanin=1.3, beta_m=0.25, beta_n=0.3)
    b.add_sphere(radius=1.0, material=1)
    b.add_point_light(p=(0, 3, 0), I=(5, 5, 5))
    jscene = b.finalize()
    return jscene, bridge(jscene)


@pytest.mark.parametrize("shuffle", [None, 5])
def test_build_grid_matches_jax(shuffle):
    jv, tv, radius, _ = _vps_events(np.random.default_rng(1))
    want = jsppm._build_grid(jv, jnp.asarray(radius), max_vps=32,
                             shuffle=None if shuffle is None else jnp.uint32(shuffle))
    got = sppm.build_grid(tv, torch.as_tensor(radius), 32, shuffle=shuffle)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.cell_of_entry.numpy(), np.asarray(want.cell_of_entry))
    np.testing.assert_array_equal(got.w_scale.numpy(), np.asarray(want.w_scale))
    np.testing.assert_array_equal(got.grid_min.numpy(), np.asarray(want.grid_min))
    assert got.res == int(want.res) and got.overflow == int(want.overflow) > 0
    assert float(got.inv_cell) == float(want.inv_cell)


@pytest.mark.parametrize("max_ev", [32, 64])
def test_deposit_matches_jax(max_ev, deposit_scene):
    """The plain deposit (S1's twin) against _deposit_events on the same VPs
    (Lambert, Oren-Nayar and hair lobes) and events, with buckets deeper
    than max_ev."""
    jscene, scene = deposit_scene
    jv, tv, radius, ev = _vps_events(np.random.default_rng(2))
    jgrid = jsppm._build_grid(jv, jnp.asarray(radius), max_vps=max_ev, shuffle=jnp.uint32(1))
    grid = sppm.build_grid(tv, torch.as_tensor(radius), max_ev, shuffle=1)
    want_phi, want_m = jsppm._deposit_events(
        jscene, jv, jnp.asarray(radius), jgrid, *[jnp.asarray(x) for x in ev], max_ev,
        jnp.uint32(1), jnp.uint32(7))
    work = {}
    inputs = sppm.deposit_inputs(tv, torch.as_tensor(radius), grid,
                                 *[torch.as_tensor(x) for x in ev], max_ev, 1, 7)
    rows, start27, okc27, nbf27, (ss, ts, ns), wo_l, r2 = inputs
    b = sppm.bx.make_bsdf_from_mat(scene, tv.mat)
    phi, m = sk.deposit_plain(rows, start27, okc27, nbf27, tv.p, ss, ts, ns, wo_l, r2, b,
                              max_ev, work=work)
    np.testing.assert_array_equal(m.numpy(), np.asarray(want_m))
    hair = (tv.mat == 3).numpy()
    np.testing.assert_allclose(phi.numpy()[~hair], np.asarray(want_phi)[~hair], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(phi.numpy()[hair], np.asarray(want_phi)[hair], rtol=1e-4,
                               atol=1e-6)
    # the wrapper on CPU tensors is the plain version; each lobe was reached
    phi2, m2 = sppm.deposit_events(scene, tv, torch.as_tensor(radius), grid,
                                   *[torch.as_tensor(x) for x in ev], max_ev, 1, 7)
    assert torch.equal(phi2, phi) and torch.equal(m2, m)
    assert work["near"] > 1000 and work["tested"] > work["near"] and work["hair_near"] > 100
    for mat in (1, 2, 3):
        assert float(m[tv.mat == mat].sum()) > 0
    # the cluster's buckets hold more events than the scan reaches
    depth = torch.bincount(rows[:, 10].to(torch.int64))
    assert int(depth[:-1].max()) > max_ev


def test_max_ev_doubles_on_overflow():
    """An iteration whose VP buckets overflow doubles the scan (with a
    warning) up to MAX_VPS_CAP; none leaves it as it is."""
    jv, tv, radius, _ = _vps_events(np.random.default_rng(1))
    grid = sppm.build_grid(tv, torch.as_tensor(radius), sppm.MAX_VPS_PER_CELL, shuffle=0)
    assert grid.overflow > 0
    with pytest.warns(UserWarning, match="32 -> 64"):
        assert sppm.adapt_max_vps(sppm.MAX_VPS_PER_CELL, grid.overflow) == 64
    assert sppm.adapt_max_vps(sppm.MAX_VPS_CAP, grid.overflow) == sppm.MAX_VPS_CAP
    assert sppm.adapt_max_vps(sppm.MAX_VPS_PER_CELL, 0) == sppm.MAX_VPS_PER_CELL


def test_kernel_refuses_other_lobes(deposit_scene):
    """S1 evaluates Lambert, Oren-Nayar and hair only: a VP of another lobe
    raises (the wrapper checks before a launch)."""
    _, scene = deposit_scene
    mat = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    b = sppm.bx.make_bsdf_from_mat(scene, mat)
    okc = torch.ones((27, 4), dtype=torch.bool)
    sk.check_lobes(okc, b)
    glass = b._replace(kind0=torch.full_like(b.kind0, sppm.bx.LOBE_FRESNEL_SPEC))
    with pytest.raises(ValueError, match="lobes"):
        sk.check_lobes(okc, glass)
    sk.check_lobes(torch.zeros((27, 4), dtype=torch.bool), glass)  # no VP scans a cell


@pytest.mark.parametrize("name", ["caustic_only", "caustic_hair"])
def test_caustic_scene_tables_equal_parsed_file(name):
    jscene, jcamera, jcfg, jscfg, _, _ = load_pbrt(str(_caustic.SCENES / f"{name}.pbrt"), {})
    scene, camera = getattr(caustic_scenes, name)(device="cpu")
    assert_tables_equal(scene, jscene)
    np.testing.assert_allclose(scene.sph_attr.numpy(), np.asarray(jscene.sph_attr), rtol=1e-6,
                               atol=1e-6)
    if name == "caustic_hair":
        np.testing.assert_array_equal(scene.crv_attr.numpy(), np.asarray(jscene.crv_attr))
        assert scene.has_hair and scene.n_curve_segs == 48
    want = cam.camera_from_numpy({f.name: getattr(jcamera, f.name)
                                  for f in dataclasses.fields(jcamera)}, device="cpu")
    assert camera.resolution == want.resolution == caustic_scenes.RESOLUTION
    for f in dataclasses.fields(want):
        a, b = getattr(camera, f.name), getattr(want, f.name)
        if torch.is_tensor(b):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f.name)
    cfg = caustic_scenes.CFG
    assert (cfg.integrator, cfg.max_depth) == (jcfg.integrator, jcfg.max_depth) == ("sppm", 5)
    for k in ("n_iterations", "photons_per_iteration", "initial_radius"):
        assert cfg.extra[k] == jcfg.extra[k]
    assert (jscfg.kind, jscfg.spp) == (1, 1)


CROP = (0.25, 0.75, 0.1, 0.6)


def _crop_text():
    """caustic_only at 24x24, 2 iterations, depth 3, with the extra keys
    set: 400 photons an iteration, radius 0.2."""
    return _caustic.scene_text("caustic_only", 24, iterations=2, depth=3).replace(
        '"integer maxdepth" 3', '"integer maxdepth" 3 "integer photonsperiteration" 400 '
        '"float radius" 0.2')


def test_sppm_render_with_crop_matches_jax(tmp_path):
    text = _crop_text()
    want = _caustic.jax_renders({"sppm": (text, CROP)}, tmp_path)
    st = {}
    got = _caustic.port_render(text, tmp_path, "sppm", stats=st, crop=CROP)
    img = want["sppm"]
    assert got.shape == img.shape == (24, 24, 3) and np.isfinite(got).all()
    assert img.mean() > 0.01 and (got[:2] == 0).all() and (got[:, :6] == 0).all()
    np.testing.assert_allclose(got, img, rtol=2e-3, atol=2e-3)
    assert st["grid_bucket_overflow"] == int(want["sppm:grid_bucket_overflow"])
    assert st["grid_res_last"] == int(want["sppm:grid_res_last"])
    assert st["camera_rays"] == 12 * 12 * 2 and st["iterations"] == 2
    assert st["max_ev_last"] in (sppm.MAX_VPS_PER_CELL, sppm.MAX_VPS_CAP)


def test_caustic_sppm_self_golden(tmp_path):
    """The port's render of tests/_selfgolden.py's caustic_sppm (48x48, 4
    iterations) held to the JAX package's committed golden."""
    fname, res, _, patches = sg.CONFIGS["caustic_sppm"]
    text = _caustic.scene_text(fname[:-5], res)
    for old, new in patches.items():
        assert old in text
        text = text.replace(old, new)
    got = _caustic.port_render(text, tmp_path, "golden")
    want = np.load(sg.golden_path("caustic_sppm"))["img"].astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    scale = max(float(want.max()), 1e-3)
    assert err.mean() / scale < 5e-3, f"mae {err.mean():.5f} (scale {scale:.3f})"
    assert float((err.max(-1) / scale > 5e-2).mean()) < 0.01
