"""rs_pbrt_tpu_torch's renders of the Cornell box through the other cameras
and filters against the JAX package's renders of the same scene, camera,
filter and Sobol' samples.

The port's images must match the JAX images within rtol = atol = 2e-3 per
pixel (tests/test_torch_render.py's image tolerance): 16x16, 4 spp, depth
3, path, through the orthographic camera with the Mitchell filter and a
crop window (samples at the crop's edge splat outside it), the realistic
camera (the singlet of tests/test_realistic.py:16, an 8 mm aperture,
focused at 1078, a 35 mm film diagonal) with the Gaussian filter, the
perspective camera with motion and the triangle filter; whitted through
the environment camera with the sinc filter at radius 2 (5 x 5 taps: at
its default radius 4, XLA takes ~40 s more to compile the 81 taps'
scatters; tests/test_torch_filters.py holds the default's splat to the
JAX one); SPPM (2 iterations at 8x8) through the orthographic camera.
The JAX renders run in one subprocess
whose XLA contracts no FMAs (XLA_FLAGS=--xla_cpu_max_isa=SSE4_2), one
compile each, as tests/_texscene.py runs its renders.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import film as fm
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
RES, SPP, DEPTH = (16, 16), 4, 3
SPPM_RES, SPPM_ITERATIONS = (8, 8), 2
SINGLET = [50.0, 5.0, 1.5, 20.0, -50.0, 45.0, 1.0, 20.0]
CORNELL = ([278, 273, -800], [278, 273, 0], [0, 1, 0])
MOVED = ([310, 290, -770], [268, 276, 0], [0.05, 1, 0])  # the motion's other end
INSIDE = ([278, 273, 280], [278, 273, 560], [0, 1, 0])  # the environment camera
WINDOW = (-300.0, 300.0, -300.0, 300.0)  # the orthographic camera's screen window
CROP = (0.25, 0.75, 0.3, 0.9)
# tag -> (camera, filter (kind, radius or None for the kind's default),
# integrator, crop)
JOBS = {
    "ortho_mitchell_crop": ("ortho", (3, None), "path", CROP),
    "realistic_gaussian": ("realistic", (2, None), "path", None),
    "motion_triangle": ("motion", (1, None), "path", None),
    "env_sinc_whitted": ("env", (4, 2.0), "whitted", None),
    "sppm_ortho": ("ortho", (0, None), "sppm", None),
}


def make_camera(pkg, kind, res, **dev):
    """The job's camera through either package's cameras and transforms."""
    cams, xf = pkg
    if kind == "ortho":
        return cams.make_orthographic(xf.look_at(*CORNELL), res, screen_window=WINDOW, **dev)
    if kind == "realistic":
        return cams.make_realistic(xf.look_at(*CORNELL), res, SINGLET, aperture_diameter=8.0,
                                   focus_distance=1078.0, film_diag_mm=35.0, **dev)
    if kind == "motion":
        return cams.make_perspective(xf.look_at(*CORNELL), res, fov=39.3077,
                                     cam_to_world_end=xf.look_at(*MOVED), **dev)
    return cams.make_environment(xf.look_at(*INSIDE), res, **dev)


def cfgs(rcfg, tag):
    """(RenderCfg, spp of the sampler) of a job, for either package's
    RenderCfg class."""
    _, _, integrator, crop = JOBS[tag]
    if integrator == "sppm":
        return rcfg("sppm", 1, DEPTH, 1.0, extra=dict(n_iterations=SPPM_ITERATIONS)), 1
    return rcfg(integrator, SPP, DEPTH, 1.0, crop=crop), SPP


_JAX_RENDERS = r"""
import json, sys
import numpy as np
import test_torch_camera_render as T
from rs_pbrt_tpu.models import cameras, samplers
from rs_pbrt_tpu.models.integrators import render as rdr
from rs_pbrt_tpu.ops import film
from rs_pbrt_tpu.scene import presets
from rs_pbrt_tpu.utils import transform as tr
out = {}
for tag in json.load(open(sys.argv[1])):
    kind, fkind, integrator, crop = T.JOBS[tag]
    res = T.SPPM_RES if integrator == "sppm" else T.RES
    scene, _ = presets.cornell_box(res)
    camera = T.make_camera((cameras, tr), kind, res)
    cfg, spp = T.cfgs(rdr.RenderCfg, tag)
    img = rdr.render(scene, camera, cfg, samplers.make_sampler(samplers.SOBOL, spp, res),
                     film.make_filter(fkind[0], fkind[1], fkind[1]))
    out[tag] = np.asarray(img, np.float64)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_images(tmp_path_factory):
    """{tag: the JAX package's image of JOBS[tag]}, one subprocess."""
    tmp = tmp_path_factory.mktemp("camera_render")
    (tmp / "jobs.json").write_text(json.dumps(list(JOBS)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    subprocess.run([sys.executable, "-c", _JAX_RENDERS, str(tmp / "jobs.json"),
                    str(tmp / "out.npz")], env=env, check=True, timeout=900, cwd=ROOT)
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("tag", list(JOBS))
def test_render_matches_jax(jax_images, tag):
    kind, fkind, integrator, crop = JOBS[tag]
    res = SPPM_RES if integrator == "sppm" else RES
    scene, _ = presets.cornell_box(res, device="cpu")
    camera = make_camera((cam, tr), kind, res, device="cpu")
    cfg, spp = cfgs(rdr.RenderCfg, tag)
    img = rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, spp, res),
                     fm.make_filter(fkind[0], fkind[1], fkind[1])).numpy()
    want = jax_images[tag]
    w, h = res
    assert img.shape == want.shape == (h, w, 3) and np.isfinite(img).all()
    assert want.mean() > 1e-3
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)
    if crop is not None:  # samples at the crop's edge splat outside it
        px0, px1, py0, py1 = rdr.crop_pixel_rect(res, crop)
        inside = np.zeros((h, w), bool)
        inside[py0:py1, px0:px1] = True
        assert (img[~inside].max(-1) > 0).any()
        ring = np.zeros((h, w), bool)
        ring[max(py0 - 2, 0):py1 + 2, max(px0 - 2, 0):px1 + 2] = True
        assert (img[~ring] == 0).all()
