"""rs_pbrt_tpu_torch's volumetric path integrator (models/integrators/
volpath.py) against the JAX package's volpath.radiance on the same camera
rays and Sobol' indices, BASELINE config 4 (assets/scenes/
sss_dragonette.pbrt) against its self-golden, and the scenes of
tools/sss_scenes.py against the JAX front end's and builder's tables.

Scenes: the vacuum Cornell box (16x16, 2 spp, depth 5); a homogeneous
absorbing fog (tests/test_integrators.py:114-135, 9x9, 4 spp, depth 3);
a grid medium of constant density and a heterogeneous, scattering one
(tests/test_integrators.py:307-357, 9x9, 4 spp, depth 2 and 3: M1 and M2's
plain versions); the dragonette parsed by the JAX front end (16x16, 2 spp,
depth 6: subsurface transport).  The JAX radiance is computed without FMA
contraction in a subprocess (tests/_volpath.py).

Tolerances: per lane rtol = atol = 2e-3 (the bound of
tests/test_torch_path_general.py, the same estimator and samples with float
association the only difference; the tracking's distances differ from the
JAX ones by ~1e-7, test_torch_medium.py); the port's render of the
dragonette at 48x48, 4 spp against tests/goldens/self/sss_dragonette.npz
with test_self_goldens.py's own limits (mean absolute error below 5e-3 of
the image's maximum, under 1% of the pixels off by more than 5e-2 of it;
the JAX test of that golden is slow, so only the port renders here); the
tables allclose 1e-6 (test_torch_scene.py's), the media and BSSRDF tables
equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _volpath as V
from rs_pbrt_tpu.scene.api import load_pbrt
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.models.integrators import volpath
from rs_pbrt_tpu_torch.ops import film as filmmod
from rs_pbrt_tpu_torch.ops import medium_kernel as mk
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.tools import sss_scenes
from test_torch_hair import _self_golden_limits
from test_torch_scene import assert_tables_equal

import _selfgolden as sg

torch.set_num_threads(2)

LANE_TAGS = ("cornell", "fog", "grid_const", "grid_hetero", "dragonette")


@pytest.fixture(scope="module")
def jax_lanes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("volpath")
    path = tmp / "dragonette.pbrt"
    path.write_text(V.dragonette_text(16, 2))
    return V.jax_lanes(LANE_TAGS, tmp, files={"dragonette": path}), path


@pytest.mark.parametrize("tag", LANE_TAGS)
def test_radiance_matches_jax(tag, jax_lanes):
    lanes, path = jax_lanes
    name, _, res, spp, depth = V.SCENES[tag]
    scene = V.port_dragonette(path)[0] if name == "dragonette" else V.port_scene(name, res)
    assert scene.has_grid == name.startswith("grid")
    assert scene.has_subsurface == (name == "dragonette")
    scfg, ctx = V.sample_ctx(res, spp)
    want = lanes[tag]
    got = volpath.radiance(scene, pathmod.PathCfg(depth, 1.0), scfg, ctx,
                           torch.as_tensor(lanes[tag + ":o"]),
                           torch.as_tensor(lanes[tag + ":d"])).numpy()
    assert got.shape == want.shape and np.isfinite(got).all() and want.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_render_sss_dragonette_self_golden(tmp_path):
    """The port's render of the parsed file at the golden's settings (48x48,
    4 spp, one batch, as tests/_selfgolden.py renders it)."""
    path = tmp_path / "dragonette48.pbrt"
    path.write_text(V.dragonette_text(48, 4))
    jscene, jcamera, jcfg, jscfg, jfcfg = load_pbrt(str(path), {})[:5]
    scene = V.port_dragonette(path)[0]
    camera = cam.camera_from_numpy({f.name: getattr(jcamera, f.name)
                                    for f in dataclasses.fields(jcamera)}, device="cpu")
    cfg = rdr.RenderCfg("volpath", jcfg.spp, jcfg.max_depth, jcfg.rr_threshold)
    assert (jcfg.integrator, jscfg.spp, jcfg.max_depth) == ("volpath", 4, 6)
    got = rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, 4, (48, 48)),
                     filmmod.FilterCfg(jfcfg.kind, jfcfg.xwidth, jfcfg.ywidth)).numpy()
    want = np.load(sg.golden_path("sss_dragonette"))["img"].astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    _self_golden_limits(got.astype(np.float64), want, "sss_dragonette")


def _media_equal(scene, jscene):
    for k in ("med_sigma_a", "med_sigma_s", "med_g", "med_grid", "med_w2m", "med_max_density"):
        np.testing.assert_array_equal(getattr(scene, k).numpy(), np.asarray(getattr(jscene, k)),
                                      err_msg=k)
    assert scene.camera_medium == int(jscene.camera_medium)
    for k in ("bss_profile", "bss_cdf", "bss_rho_eff", "bss_sigma_t", "bss_eta"):
        np.testing.assert_array_equal(getattr(scene, k).numpy(), np.asarray(getattr(jscene, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(scene.sph_attr.numpy(), np.asarray(jscene.sph_attr))


def test_sss_scene_tables_equal_parsed_file():
    jscene, jcamera, jcfg, jscfg, _, _ = load_pbrt(str(sg.SCENES + "/sss_dragonette.pbrt"), {})
    scene, camera = sss_scenes.sss_dragonette(device="cpu")
    assert_tables_equal(scene, jscene)
    _media_equal(scene, jscene)
    assert scene.has_subsurface and not scene.has_grid and scene.n_spheres == 1
    assert scene.light_type_mask == 1 << sa.LIGHT_POINT
    want = cam.camera_from_numpy({f.name: getattr(jcamera, f.name)
                                  for f in dataclasses.fields(jcamera)}, device="cpu")
    assert camera.resolution == want.resolution == sss_scenes.RESOLUTION
    for f in dataclasses.fields(want):
        a, b = getattr(camera, f.name), getattr(want, f.name)
        if torch.is_tensor(b):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f.name)
    c = sss_scenes.CFG
    assert (c.integrator, c.spp, c.max_depth) == (jcfg.integrator, jscfg.spp,
                                                  jcfg.max_depth) == ("volpath", 16, 6)


def test_smoke_scene_tables_equal_jax_builder():
    scene, _ = sss_scenes.smoke_dragonette(grid_res=16, device="cpu")
    jscene = sss_scenes.build(JaxBuilder(), sss_scenes.smoke_grid(16)).finalize()
    assert_tables_equal(scene, jscene)
    _media_equal(scene, jscene)
    assert scene.has_grid and scene.camera_medium == 0
    assert scene.med_grid.shape == (1, 16, 16, 16) and float(scene.med_grid.max()) == 1.0


def test_grid_render_takes_the_tracking_kernels_wrappers(monkeypatch):
    """render(..., "volpath") on a grid scene tracks through the M1 and M2
    wrappers (on the CPU their plain versions; no launch is counted), every
    bounce one M1 call and one M2 call, on lanes keyed by their index."""
    scene, camera = sss_scenes.smoke_dragonette(grid_res=8, resolution=(6, 6), device="cpu")
    calls = []

    def rec(name, fn):
        def wrapped(*a):
            calls.append((name, a[-3].clone(), a[-2]))
            return fn(*a)
        return wrapped

    monkeypatch.setattr(mk, "delta_track", rec("M1", mk.delta_track))
    monkeypatch.setattr(mk, "ratio_track", rec("M2", mk.ratio_track))
    before = dict(mk.launches)
    img = rdr.render(scene, camera, sss_scenes.CFG._replace(spp=2),
                     smpl.make_sampler(smpl.SOBOL, 2, (6, 6)))
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0
    depth = sss_scenes.CFG.max_depth
    assert [c[0] for c in calls] == ["M1", "M2"] * (depth + 1)
    assert [c[2] for c in calls] == [x for b in range(depth + 1) for x in (b, volpath.RATIO_SALT)]
    for _, key, _ in calls:
        assert torch.equal(key, torch.arange(72, dtype=torch.int32))
    assert mk.launches == before


def test_textures_raise():
    """Textured parameters no longer raise in volpath: with the slot mask
    set but no slot holding a texture the image is the untextured one."""
    scene, camera = sss_scenes.sss_dragonette((4, 4), device="cpu")
    go = lambda: rdr.render(scene, camera, sss_scenes.CFG._replace(spp=1),
                            smpl.make_sampler(smpl.SOBOL, 1, (4, 4)))
    before = go()
    scene.tex_slot_mask = 1
    assert torch.equal(go(), before)
