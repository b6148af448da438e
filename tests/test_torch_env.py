"""rs_pbrt_tpu_torch's infinite light against the JAX package's on the same
inputs: the 2-D distribution of an environment map (ops/sampling.py), its
lookup, pdf and sampling (models/lights.py env_le, pdf_li_env and the
infinite branches of sample_li and sample_le); that the distribution's
search copies no lane's row; and, on the port alone, the JAX package's
oracles: the furnace (tests/test_render.py:62-67, a slow test there, so
only the port renders here) and a mirror floor reflecting a constant sky
(tests/test_integrators.py:66-80).

Tolerances: the distribution's tables rtol 1e-5 (XLA and PyTorch sum the
cumulative sums in their own order); the port's search on the JAX
package's tables: indices equal, points and pdfs rtol 1e-6; env_le,
pdf_li_env, sample_li and sample_le on quadric_env's sky, the port given
the JAX package's importance tables, rtol 1e-4, atol 1e-5 (in-process
JAX, whose XLA contracts FMAs; a direction through a 4x4 transform and a
sin theta off by ulps); the oracles at their JAX
tests' bounds: the furnace sphere within 5% of the albedo-0.5 answer 0.5
and an environment pixel at 1.0 within 1e-5, the mirror at 0.7 within 5%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from rs_pbrt_tpu.models import lights as jlt
from rs_pbrt_tpu.ops import sampling as jsmp
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import lights as lt
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import sampling as smp
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import env_scenes
from rs_pbrt_tpu_torch.utils import transform as tr
from test_torch_scene import bridge

torch.set_num_threads(2)

FIELDS = ("cond_func", "cond_cdf", "cond_func_int", "marg_func", "marg_cdf", "marg_func_int")


def _maps():
    rng = np.random.default_rng(4)
    seeded = rng.gamma(0.5, 1.0, (64, 128)).astype(np.float32)
    seeded[10:12] = 0.0  # rows of zero weight: the uniform fallback's rows
    lum = env_scenes.sky_map(128, 256) @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    return {"seeded": seeded, "sky": lum.astype(np.float32)}


@pytest.mark.parametrize("name", ["seeded", "sky"])
def test_distribution_2d_matches_jax(name):
    func = _maps()[name]
    dist = smp.make_distribution_2d(torch.as_tensor(func))
    jdist = jsmp.make_distribution_2d(jnp.asarray(func))
    for k in FIELDS:
        np.testing.assert_allclose(getattr(dist, k).numpy(), np.asarray(getattr(jdist, k)),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    # the search on the JAX package's own tables: every index its
    # find_interval's
    on_jax = smp.Distribution2D(*(torch.tensor(np.asarray(getattr(jdist, k))) for k in FIELDS))
    u = np.random.default_rng(1).random((8192, 2), np.float32)
    u[:4] = [[0.0, 0.0], [0.999999, 0.999999], [0.5, 0.0], [0.0, 0.5]]
    p, pdf = smp.sample_distribution_2d(on_jax, torch.as_tensor(u))
    jp, jpdf = jsmp.sample_distribution_2d(jdist, jnp.asarray(u))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-6)
    v = smp.find_interval(on_jax.marg_cdf, torch.as_tensor(u[:, 1]))
    jv = jsmp.find_interval(jdist.marg_cdf, jnp.asarray(u[:, 1]))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    o = smp.find_interval_rows(on_jax.cond_cdf, v, torch.as_tensor(u[:, 0]))
    jo = jsmp.find_interval(jdist.cond_cdf[jv], jnp.asarray(u[:, 0]))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    q = np.random.default_rng(2).random((4096, 2), np.float32)
    np.testing.assert_allclose(smp.distribution_2d_pdf(on_jax, torch.as_tensor(q)).numpy(),
                               np.asarray(jsmp.distribution_2d_pdf(jdist, jnp.asarray(q))),
                               rtol=1e-6)


class _Largest(TorchFunctionMode):
    """Records the largest tensor any torch call returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_search_builds_no_lane_rows():
    """4,096 lanes on a 256 x 512 map: no call of the search returns more
    elements than the table or two a lane (a row a lane would be 4,096 x
    513, and the comparison count of find_interval as many)."""
    func = torch.as_tensor(np.random.default_rng(3).random((256, 512), np.float32))
    dist = smp.make_distribution_2d(func)
    u = torch.as_tensor(np.random.default_rng(5).random((4096, 2), np.float32))
    with _Largest() as mode:
        p, pdf = smp.sample_distribution_2d(dist, u)
    assert p.shape == (4096, 2) and torch.isfinite(pdf).all()
    assert mode.numel <= max(2 * 4096, dist.cond_cdf.numel())
    with _Largest() as mode:
        smp.find_interval(dist.cond_cdf[:1].expand(4096, -1), u[:, 0])
    assert mode.numel >= 4096 * 513  # the count form does build them


@pytest.fixture(scope="module")
def sky_scenes():
    """quadric_env's tables under a 64 x 128 sky from the JAX builder: the
    port's bridged scene with the JAX package's importance tables (which
    test_distribution_2d_matches_jax holds to the port's; a point next to
    the sun, whose texels are 5,000 times their neighbours, moves the
    bilinear lookup by more than the tables' ulps), and the JAX scene."""
    sky = env_scenes.sky_map(64, 128)
    jscene = env_scenes.build(JaxBuilder(), sky).finalize()
    scene = bridge(jscene)
    scene.inf_dist = smp.Distribution2D(*(torch.tensor(np.asarray(getattr(jscene.inf_dist, k)))
                                          for k in FIELDS))
    return scene, jscene


def test_env_lookup_and_pdf_match_jax(sky_scenes):
    scene, jscene = sky_scenes
    assert scene.has_env and scene.env_light == int(np.argmax(np.asarray(jscene.light_type) == 6))
    d = np.random.default_rng(7).normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    close = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lt.env_le(scene, torch.as_tensor(d)).numpy(),
                               np.asarray(jlt.env_le(jscene, jnp.asarray(d))), **close)
    np.testing.assert_allclose(lt.pdf_li_env(scene, torch.as_tensor(d)).numpy(),
                               np.asarray(jlt.pdf_li_env(jscene, jnp.asarray(d))), **close)


def test_infinite_light_sampling_matches_jax(sky_scenes):
    """sample_li and sample_le of the sky (light 2), and sample_li's pdf
    equal to pdf_li_env in its direction."""
    scene, jscene = sky_scenes
    n = 4096
    rng = np.random.default_rng(8)
    ref = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    u2, u3 = rng.random((n, 2), np.float32), rng.random((n, 2), np.float32)
    idx = np.full(n, scene.env_light, np.int32)
    close = dict(rtol=1e-4, atol=1e-5)
    ls = lt.sample_li(scene, torch.as_tensor(idx), torch.as_tensor(ref), torch.as_tensor(u2))
    jls = jlt.sample_li(jscene, jnp.asarray(idx), jnp.asarray(ref), jnp.asarray(u2))
    for k in ("wi", "li", "pdf", "p_target", "n_light"):
        np.testing.assert_allclose(getattr(ls, k).numpy(), np.asarray(getattr(jls, k)), **close,
                                   err_msg=k)
    assert not ls.is_delta.any() and (ls.pdf > 0).all()
    np.testing.assert_allclose(lt.pdf_li_env(scene, ls.wi).numpy(), ls.pdf.numpy(), rtol=1e-3)
    le = lt.sample_le(scene, torch.as_tensor(idx), torch.as_tensor(u2), torch.as_tensor(u3))
    jle = jlt.sample_le(jscene, jnp.asarray(idx), jnp.asarray(u2), jnp.asarray(u3))
    for k in ("o", "d", "n_light", "le", "pdf_pos", "pdf_dir"):
        np.testing.assert_allclose(getattr(le, k).numpy(), np.asarray(getattr(jle, k)), **close,
                                   err_msg=k)


def _render(scene, camera, integrator, spp, depth):
    return rdr.render(scene, camera, rdr.RenderCfg(integrator, spp, depth, 1.0),
                      smpl.make_sampler(smpl.SOBOL, spp, camera.resolution)).numpy()


def test_furnace_sphere():
    """A matte sphere of albedo 0.5 in a constant sky of 1: the path
    integrator's pixel on the sphere converges to 0.5 (sum of 0.5^k
    over the bounces' geometric series with the sky's 1), a pixel of
    the sky is 1."""
    scene, camera = presets.furnace_sphere((17, 17), albedo=0.5, device="cpu")
    img = _render(scene, camera, "path", 32, 8)
    np.testing.assert_allclose(img[8, 8], 0.5, rtol=0.05)
    np.testing.assert_allclose(img[1, 1], 1.0, rtol=1e-5)


def test_mirror_floor_reflects_the_sky():
    """whitted on a mirror floor under a constant sky of 0.7."""
    b = SceneBuilder()
    m = b.add_mirror(kr=(1.0, 1.0, 1.0))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-100, 0, -100], [100, 0, -100], [100, 0, 100], [-100, 0, 100]],
                        material=m)
    b.add_infinite_light(radiance_map=np.full((4, 8, 3), 0.7, np.float32))
    camera = cam.make_perspective(tr.look_at([0, 5, -10], [0, 0, 0], [0, 1, 0]), (17, 17),
                                  fov=40.0, device="cpu")
    img = _render(b.finalize("cpu"), camera, "whitted", 4, 3)
    np.testing.assert_allclose(img[8, 8], 0.7, rtol=0.05)
