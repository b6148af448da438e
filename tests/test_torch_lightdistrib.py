"""rs_pbrt_tpu_torch's spatial light selection (models/lightdistrib.py), the
per-lane distributions of ops/sampling.py it hands the path integrator, and
the film's crop window, against the JAX package on the same inputs.

The scene is a corridor 12 long, 1.5 wide and high, lit by three ceiling
quads of different power, so the voxels along it weigh the lights
differently; its AABB splits into 64 x 8 x 8 voxels.

Tolerances: the voxel tables (func, cdf, func_int) rtol 1e-5 against the
JAX package's built without FMA contraction (a subprocess with
XLA_FLAGS=--xla_cpu_max_isa=SSE4_2, as in test_torch_bvh.py), the sums of
128 light samples a voxel in an association of their own: in this process
XLA's CPU compiler contracts the light sample's products into fused
multiply-adds, which the port does not, and in the voxels that straddle a
light's plane the grazing samples' 1/cos amplifies that to 2e-5.  A
lookup's rows, the sampled pdfs and the pdf of a light rtol 1e-5 (the same
voxel; the picked light exactly), the remapped u atol 1e-5 (the cdf's
error over its step; the path integrator does not use it); renders rtol = atol = 2e-3 per
pixel and the means within 1e-4 relative, the bound
test_torch_path_general.py holds the path integrators to.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import cameras as jcam
from rs_pbrt_tpu.models import lightdistrib as jldist
from rs_pbrt_tpu.models import samplers as jsmpl
from rs_pbrt_tpu.models.integrators import render as jrdr
from rs_pbrt_tpu.ops import sampling as jsmp
from rs_pbrt_tpu.scene import presets as jpresets
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import lightdistrib as ldist
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import lowdiscrepancy as ld
from rs_pbrt_tpu_torch.ops import path_kernel as pk
from rs_pbrt_tpu_torch.ops import sampling as smp
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)

RES, SPP, DEPTH = (16, 16), 2, 5
TESTS = Path(__file__).resolve().parent


def _corridor(b):
    """Floor, ceiling, back wall and two partitions of a corridor along x,
    and three ceiling lights of radiance 4, 16 and 48."""
    white = b.add_matte(kd=(0.7, 0.7, 0.7))
    dark = b.add_matte(kd=(0.0, 0.0, 0.0))

    def quad(p, mat, area_light=None):
        b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], np.asarray(p, np.float32), material=mat,
                            area_light=area_light)

    quad([[0, 0, 0], [12, 0, 0], [12, 0, 1.5], [0, 0, 1.5]], white)  # floor, facing up
    quad([[0, 1.5, 0], [0, 1.5, 1.5], [12, 1.5, 1.5], [12, 1.5, 0]], white)  # ceiling
    quad([[0, 0, 1.5], [12, 0, 1.5], [12, 1.5, 1.5], [0, 1.5, 1.5]], white)  # back wall
    for x in (4.0, 8.0):  # partitions, open at the front
        quad([[x, 0, 0.6], [x, 0, 1.5], [x, 1.5, 1.5], [x, 1.5, 0.6]], white)
    for x, le in ((1.5, 4.0), (6.0, 16.0), (10.5, 48.0)):
        quad([[x + 0.3, 1.45, 0.5], [x + 0.3, 1.45, 1.0], [x - 0.3, 1.45, 1.0],
              [x - 0.3, 1.45, 0.5]], dark, dict(L=(le, le, le), two_sided=False))  # facing down


def corridor():
    """(port scene, port camera, JAX scene, JAX camera)."""
    look = ([6.0, 0.75, -7.0], [6.0, 0.75, 0.75], [0, 1, 0])
    jb, b = JaxBuilder(), SceneBuilder()
    _corridor(jb)
    _corridor(b)
    return (b.finalize("cpu"), cam.make_perspective(tr.look_at(*look), RES, fov=70.0,
                                                    device="cpu"),
            jb.finalize(), jcam.make_perspective(jtr.look_at(*look), RES, fov=70.0))


_JAX_NO_FMA = """
import sys
import numpy as np
from rs_pbrt_tpu.models import lightdistrib as jldist
from rs_pbrt_tpu.scene.builder import SceneBuilder
from test_torch_lightdistrib import _corridor
b = SceneBuilder()
_corridor(b)
sd = jldist.build_spatial(b.finalize())
np.savez(sys.argv[1], n_voxels=np.asarray(sd.n_voxels), **{k: np.asarray(getattr(sd, k))
         for k in ("func", "cdf", "func_int", "bounds_min", "inv_extent")})
"""


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(port scene, port SpatialDistrib, the JAX package's SpatialDistrib of
    the same scene built without FMA contraction)."""
    out = tmp_path_factory.mktemp("spatial") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent), str(TESTS)]))
    subprocess.run([sys.executable, "-c", _JAX_NO_FMA, str(out)], env=env, check=True,
                   timeout=300, cwd=TESTS.parent)
    z = np.load(out)
    jsd = jldist.SpatialDistrib(*(jnp.asarray(z[k]) for k in ("func", "cdf", "func_int",
                                                              "bounds_min", "inv_extent")),
                                tuple(int(v) for v in z["n_voxels"]))
    scene = corridor()[0]
    return scene, ldist.build_spatial(scene), jsd


def test_radical_inverse_bit_equal():
    from rs_pbrt_tpu.ops import lowdiscrepancy as jld

    a = np.concatenate([np.arange(300), np.random.default_rng(0).integers(0, 1 << 32, 2000),
                        [(1 << 32) - 1]]).astype(np.uint32)
    for base in range(len(ld.PRIMES)):
        got = ld.radical_inverse(base, torch.as_tensor(a.astype(np.int64))).numpy()
        np.testing.assert_array_equal(got, np.asarray(jld.radical_inverse(base, jnp.asarray(a))))


def test_build_spatial_matches_jax(tables):
    scene, sd, jsd = tables
    lo, hi = ldist.scene_aabb(scene)
    jlo, jhi = jldist.scene_aabb(corridor()[2])
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    assert sd.n_voxels == jsd.n_voxels == (64, 8, 8)
    for k in ("func", "cdf", "func_int", "bounds_min", "inv_extent"):
        got, want = getattr(sd, k).numpy(), np.asarray(getattr(jsd, k))
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k)
    # the voxels under each light weigh it most
    f = sd.func.reshape(64, 8, 8, 3)
    for light, x in enumerate((1.5, 6.0, 10.5)):
        assert int(f[int(x / 12 * 64), 6, 5].argmax()) == light


def test_lookup_and_per_lane_sampling_match_jax(tables):
    """lookup's rows, and the per-lane distributions sampled and evaluated
    through the same functions as the shared one, at points inside and
    outside the AABB and NaN points (which take voxel 0)."""
    _, sd, jsd = tables
    rng = np.random.default_rng(3)
    p = rng.uniform([-2, -1, -1], [14, 2.5, 2.5], (4000, 3)).astype(np.float32)
    p[:5] = np.nan
    u = rng.uniform(0, 1, 4000).astype(np.float32)
    got = ldist.lookup(sd, torch.as_tensor(p))
    want = jldist.lookup(jsd, jnp.asarray(p))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    np.testing.assert_array_equal(got.func[:5].numpy(), sd.func[[0] * 5].numpy())
    o, pdf, ur = smp.sample_distribution_1d_discrete(got, torch.as_tensor(u))
    jo, jpdf, jur = jsmp.sample_distribution_1d_discrete(want, jnp.asarray(u))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-5)
    np.testing.assert_allclose(ur.numpy(), np.asarray(jur), rtol=0, atol=1e-5)
    idx = rng.integers(0, 3, 4000)
    got_pdf = smp.distribution_1d_discrete_pdf(got, torch.as_tensor(idx)).numpy()
    want_pdf = np.asarray(jsmp.distribution_1d_discrete_pdf(want, jnp.asarray(idx)))
    np.testing.assert_allclose(got_pdf, want_pdf, rtol=1e-5)
    # a per-lane table of identical rows gives the shared table's samples
    shared = smp.make_distribution_1d(torch.tensor([1.0, 4.0, 2.0]))
    rows = smp.Distribution1D(*(t.expand((4000,) + t.shape) for t in shared))
    for a, b in zip(smp.sample_distribution_1d_discrete(shared, torch.as_tensor(u)),
                    smp.sample_distribution_1d_discrete(rows, torch.as_tensor(u))):
        assert torch.equal(a, b)


CROP = (0.25, 0.75, 0.1, 0.6)


@pytest.mark.parametrize("case", ["corridor-spatial", "corridor-spatial-crop", "cornell-crop"])
def test_render_matches_jax(case):
    """A path render with spatial light selection (the general bounce: the
    bounce kernel selects by power), with and without a crop window, and a
    crop window on the Cornell box (the bounce kernel's grid)."""
    name, strategy, crop = {"corridor-spatial": ("corridor", "spatial", None),
                            "corridor-spatial-crop": ("corridor", "spatial", CROP),
                            "cornell-crop": ("cornell", "power", CROP)}[case]
    if name == "corridor":
        scene, camera, jscene, jcamera = corridor()
        assert pk.mega_cfg(scene) is not None  # only the spatial selection refuses it
    else:
        scene, camera = presets.cornell_box(RES, device="cpu")
        jscene, jcamera = jpresets.cornell_box(RES)
    cfg = rdr.RenderCfg("path", SPP, DEPTH, 1.0, light_strategy=strategy, crop=crop)
    img = rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, SPP, RES)).numpy()
    want = np.asarray(jrdr.render(jscene, jcamera,
                                  jrdr.RenderCfg("path", spp=SPP, max_depth=DEPTH, rr_threshold=1.0,
                                                 light_strategy=strategy, crop=crop),
                                  jsmpl.make_sampler(jsmpl.SOBOL, SPP, RES), regen=False))
    assert img.shape == want.shape == (RES[1], RES[0], 3) and want.mean() > 0.01
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)
    assert abs(img.mean() - want.mean()) < 1e-4 * want.mean()
    if crop is not None:
        px0, px1, py0, py1 = rdr.crop_pixel_rect(RES, crop)
        assert (px0, px1, py0, py1) == jrdr.crop_pixel_rect(RES, crop) == (4, 12, 2, 10)
        inside = np.zeros(img.shape[:2], bool)
        inside[py0:py1, px0:px1] = True
        assert (img[~inside] == 0).all() and img[inside].mean() > want.mean()


def test_crop_pixels_equal_the_whole_film():
    """The crop window's pixels draw the Sobol' indices of their film
    coordinates, so a crop render equals the whole render inside it."""
    scene, camera, _, _ = corridor()
    scfg = smpl.make_sampler(smpl.SOBOL, SPP, RES)
    full = rdr.render(scene, camera, rdr.RenderCfg("path", SPP, DEPTH, 1.0), scfg).numpy()
    part = rdr.render(scene, camera, rdr.RenderCfg("path", SPP, DEPTH, 1.0), scfg,
                      crop=CROP).numpy()
    px0, px1, py0, py1 = rdr.crop_pixel_rect(RES, CROP)
    np.testing.assert_array_equal(part[py0:py1, px0:px1], full[py0:py1, px0:px1])
