"""rs_pbrt_tpu_torch's point, spot and distant lights (models/lights.py),
the whitted and directlighting integrators and the spatial light
distribution under them, and the bounce kernel's refusal of curves, hair
and non-area lights, against the JAX package on the same inputs.

The scene: a matte floor, a matte and a mirror sphere, lit by a point
light, a spot light aimed at the floor (full intensity within 25 degrees,
falling off to 0 at 30) and a distant light.

Tolerances: the scene tables allclose 1e-6 (test_torch_scene.py's);
sample_li rtol 1e-6 (atol 1e-7; a spot's falloff delta^4 within 4e-6 where
cos theta lies within 1e-3 of the cone's edges, the same formula in
another float association); per-lane radiance and renders rtol = atol =
2e-3 (test_torch_direct.py's bound); the spatial distribution's tables
rtol 1e-5 (test_torch_lightdistrib.py's).
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
from rs_pbrt_tpu.models import lights as jlt
from rs_pbrt_tpu.models.integrators import render as jrdr
from rs_pbrt_tpu.models import samplers as jsmpl
from rs_pbrt_tpu.ops import pallas_path as jpp
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import lightdistrib as ldist
from rs_pbrt_tpu_torch.models import lights as lt
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import path_kernel as pk
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import hair_scenes
from rs_pbrt_tpu_torch.utils import transform as tr
from test_torch_direct import INTEGRATORS, sample_ctx
from test_torch_scene import assert_tables_equal, bridge

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
RES, SPP, DEPTH = (16, 16), 2, 3
SPOT_P, SPOT_TO = (0.5, 3.0, 0.5), (0.0, 0.0, 0.0)
LOOK = ([0, 2.2, 6.5], [0, 1.0, 0], [0, 1, 0])


def build(cls, lights=("point", "spot", "distant")):
    b = cls()
    floor = b.add_matte(kd=(0.6, 0.6, 0.6))
    matte = b.add_matte(kd=(0.5, 0.2, 0.2))
    mirror = b.add_mirror(kr=(0.9, 0.9, 0.9))
    quad = np.asarray([[-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6]], np.float32)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], quad, material=floor)
    xf = jtr if cls is JaxBuilder else tr
    b.add_sphere(xf.translate([-1.1, 1.0, 0]), radius=1.0, material=matte)
    b.add_sphere(xf.translate([1.1, 1.0, 0.4]), radius=1.0, material=mirror)
    if "point" in lights:
        b.add_point_light(p=(-2.0, 3.0, 2.0), I=(6.0, 5.0, 4.0))
    if "spot" in lights:
        b.add_spot_light(p=SPOT_P, to=SPOT_TO, I=(20.0, 20.0, 24.0), cone_angle=30.0,
                         cone_delta=5.0)
    if "distant" in lights:
        b.add_distant_light(from_p=(1.0, 2.0, 1.5), to=(0, 0, 0), L=(0.8, 0.7, 0.6))
    return b.finalize("cpu") if cls is SceneBuilder else b.finalize()


@pytest.fixture(scope="module")
def scenes():
    jscene = build(JaxBuilder)
    jcamera = jcam.make_perspective(jtr.look_at(*LOOK), RES, fov=45.0)
    camera = cam.make_perspective(tr.look_at(*LOOK), RES, fov=45.0, device="cpu")
    return build(SceneBuilder), jscene, camera, jcamera


def test_delta_light_tables(scenes):
    scene, jscene, _, _ = scenes
    for port in (scene, bridge(jscene)):
        assert_tables_equal(port, jscene)
        assert port.light_type_mask == ((1 << sa.LIGHT_POINT) | (1 << sa.LIGHT_SPOT)
                                        | (1 << sa.LIGHT_DISTANT))


def _spot_refs(rng, n):
    """Floor points inside the spot's full cone, in its falloff and outside
    it: cos theta to the spot's axis above cos 25, between cos 30 and cos
    25, below cos 30."""
    p = np.asarray(SPOT_P)
    axis = (np.asarray(SPOT_TO) - p) / np.linalg.norm(np.asarray(SPOT_TO) - p)
    pts = np.stack([rng.uniform(-4, 4, 40 * n), np.zeros(40 * n), rng.uniform(-4, 4, 40 * n)], -1)
    v = pts - p
    cos = (v / np.linalg.norm(v, axis=1, keepdims=True)) @ axis
    c25, c30 = np.cos(np.deg2rad(25.0)), np.cos(np.deg2rad(30.0))
    parts = [pts[cos > c25 + 1e-4][:n], pts[(cos < c25 - 1e-4) & (cos > c30 + 1e-4)][:n],
             pts[cos < c30 - 1e-4][:n]]
    assert all(len(x) == n for x in parts)
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("light,name", [(0, "point"), (1, "spot"), (2, "distant")])
def test_sample_li_delta(scenes, light, name):
    scene, jscene, _, _ = scenes
    rng = np.random.default_rng(light)
    n = 300
    ref = (_spot_refs(rng, n // 3) if name == "spot" else np.stack(
        [rng.uniform(-5, 5, n), rng.uniform(0, 2, n), rng.uniform(-5, 5, n)], -1)
    ).astype(np.float32)
    u2 = rng.uniform(size=(len(ref), 2)).astype(np.float32)
    idx = np.full(len(ref), light, np.int32)
    got = lt.sample_li(scene, torch.as_tensor(idx), torch.as_tensor(ref), torch.as_tensor(u2))
    want = jlt.sample_li(jscene, jnp.asarray(idx), jnp.asarray(ref), jnp.asarray(u2))
    assert got.is_delta.all() and np.asarray(want.is_delta).all()
    for k in ("wi", "li", "pdf", "p_target", "n_light"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=f"{name} {k}")
    if name == "spot":  # full, partial and no light in the three thirds
        lum = got.li.numpy().sum(-1).reshape(3, -1)
        assert (lum[0] > 0).all() and (lum[2] == 0).all()
        full = (lum[0] * ((ref[: n // 3] - SPOT_P) ** 2).sum(-1))
        np.testing.assert_allclose(full, 64.0, rtol=1e-5)
        part = lum[1] * ((ref[n // 3: 2 * (n // 3)] - SPOT_P) ** 2).sum(-1)
        assert ((part > 0) & (part < 64.0)).all()


@pytest.mark.parametrize("name", sorted(INTEGRATORS))
def test_direct_radiance_per_lane(scenes, name):
    """whitted and directlighting (all lights, one light) per lane."""
    scene, jscene, _, jcamera = scenes
    (jcfg, jctx), (cfg, ctx), o, d = sample_ctx(jcamera, spp=SPP)
    mk, fn, jmk, jfn = INTEGRATORS[name]
    want = np.asarray(jfn(jscene, jmk(DEPTH), jcfg, jctx, jnp.asarray(o), jnp.asarray(d)))
    got = fn(scene, mk(DEPTH), cfg, ctx, torch.as_tensor(o), torch.as_tensor(d)).numpy()
    assert np.isfinite(got).all() and want.mean() > 0.05
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("integrator", ["directlighting", "whitted", "path"])
def test_render_delta_lights(scenes, integrator):
    scene, jscene, camera, jcamera = scenes
    img = rdr.render(scene, camera, rdr.RenderCfg(integrator, SPP, DEPTH, 1.0),
                     smpl.make_sampler(smpl.SOBOL, SPP, RES)).numpy()
    want = np.asarray(jrdr.render(jscene, jcamera, jrdr.RenderCfg(integrator, spp=SPP,
                                                                 max_depth=DEPTH,
                                                                 rr_threshold=1.0),
                                  jsmpl.make_sampler(jsmpl.SOBOL, SPP, RES)))
    assert want.mean() > 0.05
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)


_JAX_SPATIAL = """
import sys
import numpy as np
from rs_pbrt_tpu.models import lightdistrib as jldist
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from test_torch_lights_delta import build
sd = jldist.build_spatial(build(JaxBuilder), max_voxels=16)
np.savez(sys.argv[1], n_voxels=np.asarray(sd.n_voxels), **{k: np.asarray(getattr(sd, k))
         for k in ("func", "cdf", "func_int", "bounds_min", "inv_extent")})
"""


def test_spatial_distribution_with_delta_lights(scenes, tmp_path):
    """The voxel tables of a scene lit by a point, a spot and a distant
    light, as the JAX build gives them without FMA contraction (a
    subprocess, as test_torch_lightdistrib.py builds them: at the spot
    cone's edges XLA's fused multiply-adds move cos theta - cos 30 by an
    ulp, which the falloff delta^4 amplifies to 5e-5); each light's
    estimate is its luminance over the pdf of 1."""
    scene = scenes[0]
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent), str(TESTS)]))
    subprocess.run([sys.executable, "-c", _JAX_SPATIAL, str(tmp_path / "j.npz")], env=env,
                   check=True, timeout=300, cwd=TESTS.parent)
    want = np.load(tmp_path / "j.npz")
    sd = ldist.build_spatial(scene, max_voxels=16)
    assert sd.n_voxels == tuple(int(v) for v in want["n_voxels"])
    for k in ("func", "cdf", "func_int", "bounds_min", "inv_extent"):
        np.testing.assert_allclose(getattr(sd, k).numpy(), want[k], rtol=1e-5, err_msg=k)
    # the spot's weight is 0 (floored) in the voxels its cone misses
    func = sd.func.numpy()
    assert (func[:, 1] < 1e-2 * func.sum(1)).any() and (func[:, 1] > 0.3 * func.sum(1)).any()


def test_mega_cfg_refuses_curves_hair_and_delta_lights():
    """The bounce kernel takes triangles, matte materials and area lights
    only (pallas_path.py:114-135): a point light, curves or a hair material
    send a scene to the general bounce, in both packages."""
    def quad_scene(cls, **kw):
        b = cls()
        b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                            np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                                       np.float32))
        b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                            np.asarray([[-.2, 1, -.2], [.2, 1, -.2], [.2, 1, .2], [-.2, 1, .2]],
                                       np.float32), area_light=dict(L=(5, 5, 5)))
        if kw.get("point"):
            b.add_point_light(p=(0, 2, 0))
        if kw.get("hair"):
            b.add_hair()
        if kw.get("curve"):
            b.add_curve(np.asarray([[0, 0, 0], [0, .3, 0], [0, .6, 0], [0, 1, 0]], np.float32),
                        width=0.05)
        return b.finalize("cpu") if cls is SceneBuilder else b.finalize()

    assert pk.mega_cfg(quad_scene(SceneBuilder)) is not None
    for kw in (dict(point=True), dict(hair=True), dict(curve=True)):
        jscene = quad_scene(JaxBuilder, **kw)
        assert jpp.mega_cfg(jscene) is None, kw
        assert pk.mega_cfg(quad_scene(SceneBuilder, **kw)) is None, kw
        assert pk.mega_cfg(bridge(jscene)) is None, kw
    patch, _ = hair_scenes.hair_patch((8, 8), device="cpu")
    assert pk.mega_cfg(patch) is None
