"""rs_pbrt_tpu_torch's integrators on the material grid
(tools/material_scenes.py: plastic, copper, substrate, uber, translucent,
three Disney materials, a mix and the Fourier lobe on a glossy table, under
an area light and the sky) against the JAX package on the same camera rays
and Sobol' indices: path and volpath per lane at 16x16, 4 spp, depth 5,
whitted and directlighting ("all") at depth 2 (their JAX loops unroll the
depth, which sets the subprocess's compile time), from one JAX subprocess
without FMA contraction (tests/_matscene.py); the regeneration loop per
path equal to the fixed-depth loop on the grid with a ground of 4,608
triangles (a BVH); and the earlier slices' scenes: their Bsdf keeps two
slots, and their renders are bit-equal to the ones the port made before
the other BxDFs came (tests/goldens/self/torch_matte_renders.npz, rendered
by ``_matte_renders`` below with the package at commit 0b7bbc6, 2 threads).
The per-lane renders also count the calls of F1's and F2's wrappers, which
chip_smoke.py's grid_counts states for phase 21's renders on the card.

Tolerances: per lane rtol = atol = 2e-3 (test_torch_path_general.py's
bound); regeneration bit-equal to the fixed-depth loop (each path takes
the same samples and arithmetic); the earlier scenes' renders bit-equal.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _matscene as E
import _volpath as V
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import direct
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import regen
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.models.integrators import volpath
from rs_pbrt_tpu_torch.ops import bsdf as bx
from rs_pbrt_tpu_torch.ops import fourier_kernel as fk
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import presets

torch.set_num_threads(2)

TAGS = ("path", "volpath", "whitted", "dl_all")
CHIP_TAGS = dict(path="path", volpath="volpath", whitted="whitted", dl_all="directlighting all")
GOLDEN = Path(__file__).resolve().parent / "goldens" / "self" / "torch_matte_renders.npz"


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return E.jax_results(TAGS, tmp_path_factory.mktemp("materials"))


def _port_lanes(tag, scene, o, d):
    integrator, opt = E.LANE_JOBS[tag]
    scfg, ctx = V.sample_ctx(E.RES, E.SPP)
    pcfg = pathmod.PathCfg(E.DEPTH, 1.0)
    if integrator == "path":
        return pathmod.radiance(scene, pcfg, scfg, ctx, o, d)
    if integrator == "volpath":
        return volpath.radiance(scene, pcfg, scfg, ctx, o, d)
    if integrator == "whitted":
        return direct.whitted_radiance(scene, direct.WhittedCfg(E.DIRECT_DEPTH), scfg, ctx, o, d)
    return direct.directlighting_radiance(
        scene, direct.DirectLightingCfg(E.DIRECT_DEPTH, opt["sample_all"]), scfg, ctx, o, d)


@pytest.mark.parametrize("tag", TAGS)
def test_radiance_matches_jax(tag, jax_results, monkeypatch):
    scene, _ = E.port_scene()
    assert scene.has_fourier and scene.has_env and scene.mat_kind_mask == (
        (1 << sa.N_MATERIAL_TYPES) - 1) & ~((1 << sa.GLASS) | (1 << sa.MIRROR) | (1 << sa.HAIR)
                                          | (1 << sa.SUBSURFACE))
    calls = {"fourier_eval": 0, "fourier_sample": 0}
    for name, fn in [(k, getattr(fk, k)) for k in calls]:
        def counted(*args, _name=name, _fn=fn):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(fk, name, counted)
    got = _port_lanes(tag, scene, torch.as_tensor(jax_results["o"]),
                      torch.as_tensor(jax_results["d"])).numpy()
    want = jax_results[tag]
    assert got.shape == want.shape and np.isfinite(got).all() and want.mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    sys.path.insert(0, str(E.ROOT))
    import chip_smoke

    depth = E.DEPTH if tag in ("path", "volpath") else E.DIRECT_DEPTH
    counts = chip_smoke.grid_counts(CHIP_TAGS[tag], E.SPP, scene.n_lights, depth)
    assert calls == {k: counts[k] for k in calls}


def test_regeneration_equals_fixed_depth():
    """The grid on a ground of 48 x 48 quads (a BVH): 1,024 paths through
    128 lanes give each path the fixed-depth loop's radiance, every lobe
    family and the Fourier kernels' plain versions on the way."""
    scene, camera = E.port_scene(ground_cells=48)
    accel = si.build_accel(scene, device="cpu")
    scfg = smpl.make_sampler(smpl.SOBOL, E.SPP, (E.RES, E.RES))
    pcfg = pathmod.PathCfg(E.DEPTH, 1.0)
    assert scene.n_tris > si.BRUTE_FORCE_MAX_TRIS
    assert regen.eligible(scene, pcfg, scfg, accel, E.RES * E.RES * E.SPP, lane_width=128)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, E.SPP)
    st = {}
    got = regen.radiance_regen(scene, pcfg, scfg, ctx, rays.o, rays.d, accel, lane_width=128,
                               stats=st)
    want = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, accel)
    assert st["iterations"] > 6 and float(want.mean()) > 0.1 and torch.isfinite(got).all()
    assert torch.equal(got, want)


def _matte_renders() -> dict:
    """The earlier slices' scenes at 16x16, 4 spp, depth 5: the Cornell box
    with path (the bounce kernel's plain version), spheres_direct with
    directlighting and with path."""
    out = {}
    scfg = smpl.make_sampler(smpl.SOBOL, 4, (16, 16))
    scene, camera = presets.cornell_box((16, 16), device="cpu")
    out["cornell_path"] = rdr.render(scene, camera, rdr.RenderCfg("path", 4, 5, 1.0), scfg)
    scene, camera = presets.spheres_direct((16, 16), device="cpu")
    for integrator in ("directlighting", "path"):
        out[f"spheres_{integrator}"] = rdr.render(scene, camera,
                                                  rdr.RenderCfg(integrator, 4, 5, 1.0), scfg)
    return out


def test_earlier_scenes_unchanged():
    """A matte (and mirror) scene's Bsdf has no slot beyond 1, no override
    and no Fourier table, and its renders are bit-equal to the port's
    before this slice."""
    scene, _ = presets.spheres_direct((16, 16), device="cpu")
    b = bx.make_bsdf_at(scene, type("It", (), dict(mat=torch.arange(scene.mat_attr.shape[0])))())
    assert all(getattr(b, k) is None for k in ("kind2", "kind3", "kind4", "kind5", "r2", "ax2",
                                               "eta2", "sigma2", "fou"))
    assert b.lobe_mask == ((1 << bx.LOBE_LAMBERT) | (1 << bx.LOBE_ORENNAYAR)
                           | (1 << bx.LOBE_SPEC_REFL))
    gold = np.load(GOLDEN)
    got = _matte_renders()
    assert sorted(got) == sorted(gold.files)
    for k, img in got.items():
        np.testing.assert_array_equal(img.numpy(), gold[k], err_msg=k)
