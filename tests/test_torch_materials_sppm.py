"""rs_pbrt_tpu_torch's SPPM on the material grid
(tools/material_scenes.py) against the JAX package's render at 16x16, one
iteration at depth 1 (tests/_matscene.py's subprocess without FMA
contraction; the JAX SPPM's compile sets its size): visible points on
every reflecting lobe family and the Fourier lobe, photons from the area
light and the sky.  Tolerance: per pixel rtol = atol = 2e-3
(test_torch_env_paths.py's for SPPM).
"""

import numpy as np
import torch

import _matscene as E
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr

torch.set_num_threads(2)


def test_sppm_matches_jax(tmp_path):
    want = E.jax_results(("sppm",), tmp_path)["sppm"]
    scene, camera = E.port_scene()
    st = {}
    cfg = rdr.RenderCfg("sppm", 1, E.SPPM_DEPTH, 1.0,
                        extra=dict(n_iterations=E.SPPM_ITERATIONS))
    got = rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, 1, (E.RES, E.RES)),
                     stats=st).numpy()
    assert got.shape == want.shape == (E.RES, E.RES, 3) and want.mean() > 0.05
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert st["iterations"] == E.SPPM_ITERATIONS
