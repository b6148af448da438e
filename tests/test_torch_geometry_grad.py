"""rs_pbrt_tpu_torch's geometry gradients (diff/geometry.py) against the
JAX package's.

- world_to_raster on seeded points within rtol 1e-5 (the port inverts
  the camera's matrices once, in f64; the JAX function in f32),
  unique_edges bit-equal (host numpy), translate_tris's vertex columns
  equal.
- edge_boundary_grad on tests/test_grad.py's lit quad (32x32, 64 samples
  an edge) and shadow_boundary_grad on its floating blocker (24x24, 8
  samples an edge), the same seed on both sides: within rtol 1e-3 of the
  JAX value.
- grad_loss_wrt_translation of the image's mean for the Cornell box's
  raised short box moving up (16x16, depth 1): the interior
  term (autograd through G1's plain twin and the differentiable record)
  within rtol 2e-3 of the JAX package's, the boundary term within rtol
  1e-3.
- The edge gradient is 0 where the loss weights are 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _gradscene import (BOX, BOX_DIR, BOX_MASK, EDGE, EDGE_LOOK, SHADOW, SHADOW_LOOK,
                        SHADOW_MASK, edge_build, half_weights, jax_jobs, shadow_build)
from rs_pbrt_tpu.diff import geometry as jgeo
from rs_pbrt_tpu.scene import presets as jpresets
from rs_pbrt_tpu_torch.diff import geometry as geo
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)

BOUNDARY_RTOL = 1e-3  # the edge samples' renders, per lane within the sweeps' rounding
INTERIOR_RTOL = 2e-3  # as the other gradients (tests/test_torch_grad.py)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    jax = jax_jobs(tmp_path_factory.mktemp("geo"), {"box": ("edge", dict(BOX, box=True))},
                   {"edge": ("edge", EDGE), "shadow": ("shadow", SHADOW)})
    yield jax
    jax.close()


def setup(o, scene, camera):
    cfg = rdr.RenderCfg("path", o["spp"], o.get("depth", 1), 1.0)
    return scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, o["spp"], camera.resolution)


def look(lk, res):
    eye, at, up, fov = lk
    return cam.make_perspective(tr.look_at(eye, at, up), (res, res), fov=fov, device="cpu")


def test_world_to_raster_unique_edges_translate():
    scene, camera = presets.cornell_box((16, 16), device="cpu")
    jscene, jcamera = jpresets.cornell_box(resolution=(16, 16))
    rng = np.random.default_rng(0)
    pts = rng.uniform([0, 0, 0], [556, 548, 560], (200, 3)).astype(np.float32)
    np.testing.assert_allclose(geo.world_to_raster(camera, torch.tensor(pts)).numpy(),
                               np.asarray(jgeo.world_to_raster(jcamera, jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-4)
    tris = scene.tri_attr[:scene.n_tris, sa.TA_P0:sa.TA_P0 + 9].numpy()
    ea = np.concatenate([tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]], 0)
    eb = np.concatenate([tris[:, 3:6], tris[:, 6:9], tris[:, 0:3]], 0)
    fids = np.concatenate([np.arange(scene.n_tris)] * 3)
    for got, want in zip(geo.unique_edges((ea, eb), face_ids=fids),
                         jgeo.unique_edges((ea, eb), face_ids=fids)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(geo.unique_edges((ea, eb)), jgeo.unique_edges((ea, eb))):
        np.testing.assert_array_equal(got, want)
    mask = np.zeros(scene.n_tris, bool)
    mask[BOX_MASK] = True
    off = np.asarray([1.5, -2.0, 0.25], np.float32)
    moved = geo.translate_tris(scene, torch.tensor(mask), torch.tensor(off)).tri_attr
    jmoved = jgeo.translate_tris(jscene, jnp.asarray(mask), jnp.asarray(off)).tri_attr
    np.testing.assert_array_equal(moved[:scene.n_tris].numpy(), np.asarray(jmoved)[:scene.n_tris])


def test_edge_boundary_matches_jax(jax_side):
    res = EDGE["res"]
    scene, camera, cfg, scfg = setup(EDGE, edge_build(SceneBuilder()).finalize("cpu"),
                                     look(EDGE_LOOK, res))
    got = float(geo.edge_boundary_grad(
        scene, camera, cfg, scfg, torch.ones(scene.n_tris, dtype=torch.bool), (1.0, 0.0, 0.0),
        half_weights(res, True), samples_per_edge=EDGE["spe"], seed=EDGE["seed"]))
    want = float(jax_side.results("edge")["edge:boundary"])
    assert want != 0.0
    np.testing.assert_allclose(got, want, rtol=BOUNDARY_RTOL)


def test_shadow_boundary_matches_jax(jax_side):
    res = SHADOW["res"]
    scene, camera, cfg, scfg = setup(SHADOW, shadow_build(SceneBuilder()).finalize("cpu"),
                                     look(SHADOW_LOOK, res))
    mask = np.zeros(scene.n_tris, bool)
    mask[SHADOW_MASK] = True
    got = float(geo.shadow_boundary_grad(scene, camera, cfg, scfg, mask, (1.0, 0.0, 0.0),
                                         half_weights(res, False),
                                         samples_per_edge=SHADOW["spe"]))
    want = float(jax_side.results("shadow")["shadow:shadow"])
    assert want != 0.0 and np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=BOUNDARY_RTOL)


def test_translation_grad_matches_jax(jax_side):
    r = BOX["res"]
    scene, camera = presets.cornell_box((r, r), device="cpu")
    mask = torch.zeros(scene.n_tris, dtype=torch.bool)
    mask[BOX_MASK] = True
    # raised 2 units: the box's bottom face is coplanar with the floor
    scene = geo.translate_tris(scene, mask, torch.tensor([0.0, 2.0, 0.0]))
    scene, camera, cfg, scfg = setup(BOX, scene, camera)
    w = np.full((r, r), 1.0 / (r * r), np.float32)
    res = jax_side.results("box")
    interior, boundary, total = geo.grad_loss_wrt_translation(
        scene, camera, cfg, scfg, mask, BOX_DIR, w, samples_per_edge=BOX["spe"], seed=0)
    assert float(res["box:interior"]) != 0.0 and float(res["box:boundary"]) != 0.0
    np.testing.assert_allclose(float(interior), float(res["box:interior"]), rtol=INTERIOR_RTOL)
    np.testing.assert_allclose(float(boundary), float(res["box:boundary"]), rtol=BOUNDARY_RTOL)
    assert torch.equal(total, interior + boundary)


def test_edge_grad_zero_for_zero_weights():
    scene, camera = presets.cornell_box((8, 8), device="cpu")
    scene, camera, cfg, scfg = setup(dict(spp=2, depth=2), scene, camera)
    mask = torch.zeros(scene.n_tris, dtype=torch.bool)
    mask[BOX_MASK] = True
    g = geo.edge_boundary_grad(scene, camera, cfg, scfg, mask, (1.0, 0.0, 0.0),
                               np.zeros((8, 8), np.float32), samples_per_edge=8)
    assert float(g) == 0.0
