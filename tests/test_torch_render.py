"""rs_pbrt_tpu_torch's render driver end to end, on the CPU.

The port's render of the Cornell preset must match the JAX render of the
same scene, spp and Sobol' samples within rtol = atol = 2e-3 (the
megakernel-vs-general bound, tests/test_pallas.py:157-161).  The .pbrt
Cornell box, parsed by the JAX front end and carried across with
scene_from_numpy, must meet test_cornell_golden_tiny's thresholds against
the reference renderer's published image (tests/test_golden.py:50-60).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from rs_pbrt_tpu.io import image as jimg
from rs_pbrt_tpu.models import samplers as jsmpl
from rs_pbrt_tpu.models.integrators import render as jrdr
from rs_pbrt_tpu.scene import presets as jpresets
from rs_pbrt_tpu_torch.io import image as img_io
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import film as filmmod
from rs_pbrt_tpu_torch.scene import presets
from test_torch_scene import bridge, load_pbrt_cornell

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(__file__), "goldens", "cornell_box_256_pixelsamples.png")


def test_render_matches_jax():
    res, spp = (32, 32), 4
    scene, camera = presets.cornell_box(res, device="cpu")
    img = rdr.render(scene, camera, rdr.RenderCfg("path", spp, 5, 1.0),
                     smpl.make_sampler(smpl.SOBOL, spp, res)).numpy()
    jscene, jcamera = jpresets.cornell_box(res)
    want = np.asarray(jrdr.render(jscene, jcamera, jrdr.RenderCfg("path", spp=spp, max_depth=5,
                                                                  rr_threshold=1.0),
                                  jsmpl.make_sampler(jsmpl.SOBOL, spp, res)))
    assert img.shape == want.shape == (32, 32, 3)
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)


def test_pbrt_cornell_meets_golden(tmp_path):
    """The scene file asks for spatial light selection, which the port
    renders as the JAX package does: the general bounce (the bounce kernel
    selects by power) with the spatial distribution built for the render."""
    from PIL import Image

    jscene, jcamera, jcfg, jscfg, jfcfg, _ = load_pbrt_cornell(tmp_path, 50, 4)
    assert jcfg.light_strategy == "spatial" and jscene.n_lights == 1
    scene = bridge(jscene)
    camera = cam.camera_from_numpy({f.name: getattr(jcamera, f.name)
                                    for f in dataclasses.fields(jcamera)}, device="cpu")
    cfg = rdr.RenderCfg(jcfg.integrator, jcfg.spp, jcfg.max_depth, jcfg.rr_threshold,
                        light_strategy=jcfg.light_strategy)
    fcfg = filmmod.FilterCfg(jfcfg.kind, jfcfg.xwidth, jfcfg.ywidth)
    img = rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, jscfg.spp, (50, 50)), fcfg)
    ours = img_io.to_srgb_u8(img.numpy()).astype(np.float64) / 255.0
    golden = np.asarray(Image.open(GOLD).convert("RGB"), np.float64) / 255.0
    g = golden.reshape(50, 10, 50, 10, 3).mean((1, 3))
    err = np.abs(ours - g)
    assert err.mean() < 0.11, f"mae {err.mean():.4f}"
    assert np.percentile(err.max(-1), 95) < 0.5


def test_batches_add_up():
    """spp split over several batches gives the one-batch image."""
    res = (12, 10)
    scene, camera = presets.cornell_box(res, device="cpu")
    args = (scene, camera, rdr.RenderCfg("path", 8, 3, 1.0), smpl.make_sampler(smpl.SOBOL, 8, res))
    stats = {}
    one = rdr.render(*args, stats=stats)
    split = rdr.render(*args, max_lanes=3 * res[0] * res[1])
    np.testing.assert_allclose(split.numpy(), one.numpy(), rtol=1e-6, atol=1e-7)
    assert stats["camera_rays"] == 8 * 120 and stats["paths_per_s"] > 0


def test_png(tmp_path):
    from PIL import Image

    img = np.random.default_rng(0).uniform(-0.1, 1.5, (7, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(img_io.to_srgb_u8(img), jimg._to_srgb_u8(img))
    path = tmp_path / "out.png"
    img_io.write_png(path, torch.as_tensor(img))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img_io.to_srgb_u8(img))


def test_unported_options_raise():
    """bdpt and mlt render (held to the JAX package by test_torch_bdpt.py
    and test_torch_mlt.py); an integrator neither package has raises
    ValueError naming the integrators both render; a Gaussian
    filter renders (splatted through its footprint, so the film's weights
    are the filter's, not the spp)."""
    scene, camera = presets.cornell_box((8, 8), device="cpu")
    scfg = smpl.make_sampler(smpl.SOBOL, 1, (8, 8))
    for integrator, extra in (("bdpt", None),
                              ("mlt", dict(mutations_per_pixel=2, chains=32,
                                           bootstrap_samples=64))):
        img = rdr.render(scene, camera, rdr.RenderCfg(integrator, 1, 3, 1.0, extra=extra), scfg)
        assert img.shape == (8, 8, 3) and torch.isfinite(img).all() and float(img.sum()) > 0.0
    with pytest.raises(ValueError, match="unknown integrator 'photonmap'"):
        rdr.render(scene, camera, rdr.RenderCfg("photonmap", 1, 5, 1.0), scfg)
    img = rdr.render(scene, camera, rdr.RenderCfg("path", 1, 5, 1.0), scfg,
                     filmmod.make_filter(filmmod.FILTER_GAUSSIAN, 2.0, 2.0))
    box = rdr.render(scene, camera, rdr.RenderCfg("path", 1, 5, 1.0), scfg)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    assert float(img.mean()) > 0.0 and not torch.equal(img, box)
