"""rs_pbrt_tpu_torch's ray differentials (ops/differentials.py) against the
JAX package's: camera_differentials for a pinhole and a thin-lens camera,
duv_width_at_hit at triangle and sphere hits, needs_diffs, and the
regeneration gate that declines a scene with an image map on a material
and takes one with a bump map and noise alone.

Tolerances: per lane within rtol = atol = 1e-5 of the JAX values (the same
formulas; XLA's fused multiply-adds in this process differ in ulps), the
footprints within rtol 1e-4 (a 2x2 solve of differences of nearby points).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import cameras as jcam
from rs_pbrt_tpu.ops import differentials as jrd
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import regen
from rs_pbrt_tpu_torch.ops import differentials as rd
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.ops import texture as tx
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import texture_scenes as ts
from rs_pbrt_tpu_torch.utils import transform as tr

N = 1024
RES = (32, 24)


def _cameras(lens_radius):
    jc = jcam.make_perspective(tr.look_at([0.5, 1.0, 4.0], [0.0, 0.2, 0.0], [0, 1, 0]), RES,
                               fov=50.0, lens_radius=lens_radius, focal_distance=3.5)
    pc = cam.camera_from_numpy({f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)},
                               device="cpu")
    return jc, pc


def _film_samples(seed):
    rng = np.random.default_rng(seed)
    p_film = (rng.uniform(0, 1, (N, 2)) * np.asarray(RES)).astype(np.float32)
    return p_film, rng.uniform(size=(N, 2)).astype(np.float32), rng.uniform(size=N).astype(
        np.float32)


@pytest.mark.parametrize("lens_radius", [0.0, 0.08])
@pytest.mark.parametrize("spp", [1, 16, 256])
def test_camera_differentials_match_jax(lens_radius, spp):
    jc, pc = _cameras(lens_radius)
    p_film, u_lens, u_time = _film_samples(spp)
    jr = jcam.generate_rays(jc, jnp.asarray(p_film), jnp.asarray(u_lens), jnp.asarray(u_time))
    jd = jrd.camera_differentials(jc, jr, jnp.asarray(p_film), jnp.asarray(u_lens),
                                  jnp.asarray(u_time), spp)
    t = lambda a: torch.as_tensor(a)
    pr = cam.generate_rays(pc, t(p_film), t(u_lens), t(u_time))
    pd = rd.camera_differentials(pc, pr, t(p_film), t(u_lens), t(u_time), spp)
    for k in rd.RayDiffs._fields:
        np.testing.assert_allclose(getattr(pd, k).numpy(), np.asarray(getattr(jd, k)),
                                   rtol=1e-5, atol=1e-5)
    # the offsets shrink with spp as max(1/8, 1/sqrt(spp))
    full = cam.generate_rays(pc, t(p_film) + torch.tensor([1.0, 0.0]), t(u_lens), t(u_time))
    s = max(0.125, spp ** -0.5)
    torch.testing.assert_close(pd.rx_d - pr.d, (full.d - pr.d) * s, rtol=1e-4, atol=1e-6)


def _scenes():
    def build(b):
        m = b.add_matte()
        b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                            [[-2, 0, -2], [2, 0, -2], [2, 0.3, 2], [-2, 0.3, 2]],
                            uvs=[[0, 0], [3, 0], [3, 2], [0, 2]], material=m)
        b.add_triangle_mesh([[0, 1, 2]], [[-1, 0, -1.5], [0, 1.5, -1.5], [1, 0, -1.5]],
                            material=m)  # the default uv parameterization
        b.add_sphere(tr.translate([0.8, 0.5, 0.5]), radius=0.5, material=m)
        return b
    return build(JaxBuilder()).finalize(), build(SceneBuilder()).finalize("cpu")


@pytest.mark.parametrize("spp", [1, 64])
def test_duv_width_at_hit_matches_jax(spp):
    js, ps = _scenes()
    jc, pc = _cameras(0.0)
    p_film, u_lens, u_time = _film_samples(3)
    t = lambda a: torch.as_tensor(a)
    jr = jcam.generate_rays(jc, jnp.asarray(p_film), jnp.asarray(u_lens), jnp.asarray(u_time))
    jd = jrd.camera_differentials(jc, jr, jnp.asarray(p_film), jnp.asarray(u_lens),
                                  jnp.asarray(u_time), spp)
    jit = jsi.scene_intersect(js, jr.o, jr.d, jnp.full(N, 1e30, jnp.float32))
    want = np.asarray(jrd.duv_width_at_hit(js, jit, jd))
    # the port's hit on the JAX rays and differentials
    pd = rd.RayDiffs(*(t(np.asarray(getattr(jd, k))) for k in rd.RayDiffs._fields))
    pit = si.scene_intersect(ps, t(np.asarray(jr.o)), t(np.asarray(jr.d)),
                             torch.full((N,), 1e30))
    got = rd.duv_width_at_hit(ps, pit, pd).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    hit = pit.valid.numpy()
    assert hit.mean() > 0.15 and (got[hit] > 0).mean() > 0.95 and (got[~hit] == 0).all()


def test_needs_diffs():
    """An image map bound to a slot needs differentials; an image map a
    light alone reads, or noise and a bump map, do not."""
    b = SceneBuilder()
    b.add_projection_light()
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    assert not rd.needs_diffs(b.finalize("cpu"))
    b = SceneBuilder()
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    m = b.add_matte()
    b.set_material_texture(m, sa.TEX_SLOT_BUMP, b.add_texture(tx.TEX_FBM))
    assert not rd.needs_diffs(b.finalize("cpu"))
    b.set_material_texture(m, sa.TEX_SLOT_KD, b.add_texture(
        tx.TEX_IMAGEMAP, image=np.ones((4, 4, 3), np.float32)))
    assert rd.needs_diffs(b.finalize("cpu"))
    scene, _ = ts.texture_grid((4, 4), (8, 8), device="cpu")
    assert rd.needs_diffs(scene)


def test_regeneration_gate():
    """regen.eligible declines an image-mapped scene (its refilled lanes
    would carry no differentials) and takes a bump-only one (the JAX
    render.py:389-395 gate)."""
    pcfg = pathmod.PathCfg(5, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, 16, (8, 8))
    scene, _ = ts.statue_marble((8, 8), subdivisions=5, device="cpu")
    accel = si.build_accel(scene, device="cpu")
    assert regen.eligible(scene, pcfg, scfg, accel, 1024, lane_width=128)
    b = ts.statue_marble_build(SceneBuilder(), subdivisions=5)
    b.set_material_texture(1, sa.TEX_SLOT_KS, b.add_texture(
        tx.TEX_IMAGEMAP, image=np.ones((4, 4, 3), np.float32)))
    imaged = b.finalize("cpu")
    assert rd.needs_diffs(imaged)
    assert not regen.eligible(imaged, pcfg, scfg, si.build_accel(imaged, device="cpu"), 1024,
                              lane_width=128)
