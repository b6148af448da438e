"""rs_pbrt_tpu_torch's integrators on the texture grid
(tools/texture_scenes.py: textures bound to every material slot, an image
map filtered by ray differentials, the combinators, a bump map, alpha and
shadow-alpha masks, the projection and goniometric lights; its noise
textures made constants, tests/_texscene.py says why) against the JAX
package on the same camera rays, differentials and Sobol' indices: path
per lane at 16x16, 2 spp, depth 3, whitted and directlighting ("one") at
depth 1 and ao; path on tests/_texscene.noise_build's scene, where an fbm
is a material's kd and another a bump map (the bump checked live); all
from one JAX subprocess without FMA contraction (tests/_texscene.py;
volpath and SPPM are test_torch_textured_volpath.py's, a second
subprocess that another worker runs beside this one); and on the marble
statue (a marble kd and an fbm bump map, no image map) the regeneration
loop per path equal to the fixed-depth loop.

Tolerances: per lane and per pixel rtol = atol = 2e-3
(test_torch_path_general.py's bound); regeneration bit-equal to the
fixed-depth loop (each path takes the same samples and arithmetic).
"""

import numpy as np
import pytest
import torch

import _texscene as E
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import regen
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import differentials as rd
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.ops import texture_kernel as tk
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.tools import texture_scenes as ts

torch.set_num_threads(2)

TAGS = ("path", "whitted", "dl_one", "ao", "noise_path")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return E.jax_results(TAGS, tmp_path_factory.mktemp("textures"))


@pytest.mark.parametrize("tag", TAGS)
def test_render_matches_jax(tag, jax_results):
    E.check_render(tag, jax_results)


def test_render_entry_point_takes_differentials(jax_results, monkeypatch):
    """render.render hands the camera rays' differentials to the integrator
    (the same rays the JAX subprocess made, within 1e-6), and the floor's
    image map reads footprints: T1 gets a width at bounce 0."""
    scene, camera = E.port_scene()
    widths = []
    real = tk.texture_eval

    def spy(tb, ids, uv, p, width=None):
        widths.append(width)
        return real(tb, ids, uv, p, width)
    monkeypatch.setattr(tk, "texture_eval", spy)
    scfg = smpl.make_sampler(smpl.SOBOL, E.SPP, (E.RES, E.RES))
    ctx, rays, diffs = rdr.camera_rays(camera, scfg, 0, E.SPP, diffs=True)
    for k in rd.RayDiffs._fields:
        np.testing.assert_allclose(getattr(diffs, k).numpy(), jax_results[k], atol=1e-6)
    img = rdr.render(scene, camera, rdr.RenderCfg("whitted", E.SPP, 1, 1.0), scfg)
    assert torch.isfinite(img).all()
    assert any(w is not None and float(w.max()) > 0 for w in widths)


def test_marble_statue_regenerates_per_path():
    """statue_marble (a marble kd and an fbm bump map, no image map) takes
    the regeneration loop, and 1,024 paths through 128 lanes equal the
    fixed-depth loop's, bump maps and T1's plain version on the way."""
    scene, camera = ts.statue_marble((8, 8), subdivisions=5, device="cpu")
    accel = si.build_accel(scene, device="cpu")
    scfg = smpl.make_sampler(smpl.SOBOL, 16, (8, 8))
    pcfg = pathmod.PathCfg(5, 1.0)
    assert scene.tex_slot_mask == (1 << sa.TEX_SLOT_KD) | (1 << sa.TEX_SLOT_BUMP)
    assert not rd.needs_diffs(scene)
    assert regen.eligible(scene, pcfg, scfg, accel, 8 * 8 * 16, lane_width=128)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, 16)
    st = {}
    got = regen.radiance_regen(scene, pcfg, scfg, ctx, rays.o, rays.d, accel, lane_width=128,
                               stats=st)
    want = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, accel)
    assert st["iterations"] > 6 and float(want.mean()) > 0.05 and torch.isfinite(got).all()
    assert torch.equal(got, want)
