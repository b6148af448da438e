"""Shared set-up of the port's tests on the texture grid
(rs_pbrt_tpu_torch/tools/texture_scenes.py): the scene at a small size
through either package's builder, and the JAX package's per-lane radiance
of each integrator (with the camera rays' differentials where it takes
them) and its SPPM render, computed in one subprocess whose XLA contracts
no FMAs (XLA_FLAGS=--xla_cpu_max_isa=SSE4_2), as tests/_matscene.py
computes them.

The grid's four noise textures (fbm, wrinkled, marble, windy) are made
constants of their value here (``without_noise``): XLA compiles the JAX
texture evaluation of every noise family in ~70 s on the CPU, and a
render holds ~20 of them (each bound slot, the bump map, every alpha test),
~5 s without.  tests/test_torch_texture.py holds the noise families to
the JAX package lane by lane.  ``noise_build``'s scene holds one of them,
fbm, inside a path render ("noise_path"), as a material slot's texture
and as a bump map: XLA compiles that render in ~80 s (with a marble kd
as well, ~225 s).

The subprocess calls the JAX scene_intersect and scene_intersect_p
jitted, with the scene as an argument: each eager call of the JAX alpha
recast loop compiles its while loop anew, ~13 s on this scene, and the
integrators make several such calls of one shape.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

RES, SPP, DEPTH = 16, 2, 3
DIRECT_DEPTH = 1  # whitted and directlighting unroll their depth (the JAX loops)
IMAGE_HW = (75, 100)  # the floor's image: not a power of two, a 128x128 pyramid
SPPM_ITERATIONS = 1
SPPM_DEPTH = 1

# tag -> (integrator, options); the per-lane jobs of the JAX subprocess
LANE_JOBS = {
    "path": ("path", {}),
    "noise_path": ("path", {}),  # on noise_build's scene
    "volpath": ("volpath", {}),
    "whitted": ("whitted", {}),
    "dl_one": ("directlighting", {"sample_all": False}),
    "ao": ("ao", {"n_samples": 4}),
}


def without_noise(b):
    """Builder b (either package's) with its noise textures made constants
    of their TP_VALUE.  Returns b."""
    from rs_pbrt_tpu_torch.ops import texture as tx

    for i, t in enumerate(b.textures):
        if t[0] in (tx.TEX_FBM, tx.TEX_WRINKLED, tx.TEX_MARBLE, tx.TEX_WINDY):
            b.textures[i] = (tx.TEX_CONSTANT,) + tuple(t[1:])
    return b


def noise_build(b):
    """The grid's fbm (the floor checker's child) as a plastic sphere's kd
    and the grid's fbm bump map on a matte sphere, on an untextured floor
    under the grid's area light: a scene whose only texture family is fbm,
    and which has no mask and no image map.  Returns b."""
    from rs_pbrt_tpu_torch.ops import texture as tx
    from rs_pbrt_tpu_torch.scene import arrays as sa
    from rs_pbrt_tpu_torch.tools.material_scenes import ground_mesh
    from rs_pbrt_tpu_torch.utils import transform as tr

    fbm = b.add_texture(tx.TEX_FBM, params={tx.TP_VALUE: (0.6, 0.55, 0.5), tx.TP_OCTAVES: 6,
                                            tx.TP_OMEGA: 0.55},
                        world_to_texture=tr.scale(0.5, 0.5, 0.5))
    bump = b.add_texture(tx.TEX_FBM, params={tx.TP_VALUE: (0.04, 0.04, 0.04),
                                             tx.TP_OCTAVES: 5},
                         world_to_texture=tr.scale(0.2, 0.2, 0.2))
    plastic = b.add_plastic(kd=(0.3, 0.3, 0.3), ks=(0.3, 0.3, 0.3), roughness=0.1)
    b.set_material_texture(plastic, sa.TEX_SLOT_KD, fbm)
    matte = b.add_matte(kd=(0.7, 0.7, 0.65))
    b.set_material_texture(matte, sa.TEX_SLOT_BUMP, bump)
    for x, mat in ((-0.5, plastic), (0.5, matte)):
        b.add_sphere(tr.translate([x, 1.0, 0.0]), radius=0.9, material=mat)
    idx, pos = ground_mesh(6.0, 1)
    b.add_triangle_mesh(idx, pos, material=b.add_matte(kd=(0.5, 0.5, 0.5)))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-1.0, 4.5, -1.5], [1.0, 4.5, -1.5], [1.0, 4.5, 0.5], [-1.0, 4.5, 0.5]],
                        material=b.add_matte(kd=(0.0, 0.0, 0.0)),
                        area_light=dict(L=(7.0, 6.5, 6.0)))
    return b


def port_scene(tag="path"):
    """texture_grid without noise (noise_build's scene for "noise_path") at
    RES on the CPU through the port's builder: (scene, camera)."""
    from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
    from rs_pbrt_tpu_torch.tools import texture_scenes as ts

    if tag == "noise_path":
        b = noise_build(SceneBuilder())
    else:
        b = without_noise(ts.build(SceneBuilder(), IMAGE_HW))
    return b.finalize("cpu"), ts.camera((RES, RES), "cpu")


_JAX_LANES = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
import _texscene as E
import jax
from rs_pbrt_tpu.models import cameras, samplers
from rs_pbrt_tpu.models.integrators import direct as jdirect
from rs_pbrt_tpu.models.integrators import path as jpath
from rs_pbrt_tpu.models.integrators import render as rdr
from rs_pbrt_tpu.models.integrators import volpath as jvol
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene.builder import SceneBuilder
from rs_pbrt_tpu.utils import transform as tr
from rs_pbrt_tpu_torch.tools import texture_scenes as ts
jsi.scene_intersect = jax.jit(jsi.scene_intersect)
jsi.scene_intersect_p = jax.jit(jsi.scene_intersect_p)
jobs = json.load(open(sys.argv[1]))
grid = E.without_noise(ts.build(SceneBuilder(), E.IMAGE_HW)).finalize()
res, spp, depth = E.RES, E.SPP, E.DEPTH
camera = cameras.make_perspective(tr.look_at(*ts.CAMERA[:3]), (res, res), fov=ts.CAMERA[3])
scfg = samplers.make_sampler(samplers.SOBOL, spp, (res, res))
xs, ys = np.meshgrid(np.arange(res), np.arange(res))
pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1))
ctx = samplers.make_ctx(scfg, jnp.asarray(pix, jnp.int32),
                        jnp.asarray(np.repeat(np.arange(spp), res * res), jnp.uint32),
                        frame_lt_spp=True)
rays, _, diffs = rdr._camera_rays(camera, scfg, ctx, ctx.pixel, want_diffs=True)
o, d = rays.o, rays.d
out = {"o": np.asarray(o), "d": np.asarray(d),
       **{k: np.asarray(v) for k, v in diffs._asdict().items()}}
for tag in jobs:
    if tag == "sppm":
        cfg = rdr.RenderCfg("sppm", 1, E.SPPM_DEPTH, 1.0,
                            extra=dict(n_iterations=E.SPPM_ITERATIONS))
        img = rdr.render(grid, camera, cfg, samplers.make_sampler(samplers.SOBOL, 1, (res, res)))
        out[tag] = np.asarray(img, np.float64)
        continue
    integrator, opt = E.LANE_JOBS[tag]
    pcfg = jpath.PathCfg(depth, 1.0)
    scene = grid
    if tag == "noise_path":
        scene = E.noise_build(SceneBuilder()).finalize()
        L = jpath.radiance(scene, pcfg, scfg, ctx, o, d, None, regen=False)
    elif integrator == "path":
        L = jpath.radiance(scene, pcfg, scfg, ctx, o, d, None, regen=False, diffs=diffs)
    elif integrator == "volpath":
        L = jvol.radiance(scene, pcfg, scfg, ctx, o, d, None, diffs=diffs)
    elif integrator == "whitted":
        L = jdirect.whitted_radiance(scene, jdirect.WhittedCfg(E.DIRECT_DEPTH), scfg, ctx, o, d,
                                     diffs=diffs)
    elif integrator == "ao":
        L = jdirect.ao_radiance(scene, jdirect.AOCfg(opt["n_samples"], True), scfg, ctx, o, d)
    else:
        L = jdirect.directlighting_radiance(
            scene, jdirect.DirectLightingCfg(E.DIRECT_DEPTH, opt["sample_all"]), scfg, ctx, o, d,
            diffs=diffs)
    out[tag] = np.asarray(L, np.float64)
np.savez(sys.argv[2], **out)
"""


def jax_results(tags, tmp_path: Path) -> dict:
    """{tag: the JAX package's per-lane radiance (N, 3) float64 of
    LANE_JOBS[tag] on texture_grid's camera rays at RES, SPP (lane n the
    pixel n mod RES^2, sample n div RES^2), or for "sppm" its render of
    SPPM_ITERATIONS iterations at depth SPPM_DEPTH}, with the camera rays
    as "o" and "d" and their differentials as "rx_o", "rx_d", "ry_o",
    "ry_d", computed in one subprocess without FMA contraction."""
    (tmp_path / "jobs.json").write_text(json.dumps(list(tags)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]))
    subprocess.run([sys.executable, "-c", _JAX_LANES, str(tmp_path / "jobs.json"),
                    str(tmp_path / "out.npz")], env=env, check=True, timeout=900, cwd=ROOT)
    return dict(np.load(tmp_path / "out.npz"))


def _port_lanes(tag, scene, res):
    """The port's per-lane radiance of LANE_JOBS[tag] on the JAX rays and
    differentials of res."""
    import torch

    import _volpath as V
    from rs_pbrt_tpu_torch.models.integrators import direct
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod
    from rs_pbrt_tpu_torch.models.integrators import volpath
    from rs_pbrt_tpu_torch.ops import differentials as rd

    integrator, opt = LANE_JOBS[tag]
    o, d = torch.as_tensor(res["o"]), torch.as_tensor(res["d"])
    diffs = rd.RayDiffs(*(torch.as_tensor(res[k]) for k in rd.RayDiffs._fields))
    scfg, ctx = V.sample_ctx(RES, SPP)
    pcfg = pathmod.PathCfg(DEPTH, 1.0)
    if tag == "noise_path":
        return pathmod.radiance(scene, pcfg, scfg, ctx, o, d)
    if integrator == "path":
        return pathmod.radiance(scene, pcfg, scfg, ctx, o, d, diffs=diffs)
    if integrator == "volpath":
        return volpath.radiance(scene, pcfg, scfg, ctx, o, d, diffs=diffs)
    if integrator == "whitted":
        return direct.whitted_radiance(scene, direct.WhittedCfg(DIRECT_DEPTH), scfg, ctx, o, d,
                                       diffs=diffs)
    if integrator == "ao":
        return direct.ao_radiance(scene, direct.AOCfg(opt["n_samples"], True), scfg, ctx, o, d)
    return direct.directlighting_radiance(
        scene, direct.DirectLightingCfg(DIRECT_DEPTH, opt["sample_all"]), scfg, ctx, o, d,
        diffs=diffs)


def check_render(tag, res):
    """The port's result of `tag` on the grid within rtol = atol = 2e-3 of
    the JAX one in res (jax_results'), per lane or, for "sppm", per
    pixel."""
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import differentials as rd
    from rs_pbrt_tpu_torch.scene import arrays as sa

    from rs_pbrt_tpu_torch.ops import texture as tx

    scene, camera = port_scene(tag)
    if tag == "noise_path":
        assert scene.tex_slot_mask == (1 << sa.TEX_SLOT_KD) | (1 << sa.TEX_SLOT_BUMP)
        assert scene.tex_kind_mask == 1 << tx.TEX_FBM
        assert not scene.has_alpha and not rd.needs_diffs(scene)
    else:
        assert scene.tex_slot_mask == (1 << sa.N_TEX_SLOTS) - 1
        assert scene.tex_kind_mask == 0xe1f
        assert scene.has_alpha and rd.needs_diffs(scene)
    want = res[tag]
    if tag == "sppm":
        cfg = rdr.RenderCfg("sppm", 1, SPPM_DEPTH, 1.0, extra=dict(n_iterations=SPPM_ITERATIONS))
        got = rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, 1, (RES, RES)))
    else:
        got = _port_lanes(tag, scene, res)
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all() and want.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    if tag == "noise_path":  # the bump map is live: without it lanes change
        from unittest import mock

        from rs_pbrt_tpu_torch.ops import bsdf as bx

        with mock.patch.object(bx, "apply_bump", lambda scene, it, ss, ts: (it.ns, ss, ts)):
            flat = _port_lanes(tag, scene, res).numpy()
        assert (np.abs(flat - got).max(-1) > 1e-3).mean() > 0.05
