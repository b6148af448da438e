"""rs_pbrt_tpu_torch's SPPM render of caustic_hair.pbrt, BASELINE config 5
whole (a glass sphere's caustic, two hair curves, SPPM with the random
sampler), against the JAX render of the same file.

Tolerance: per pixel rtol = atol = 2e-3 against the JAX render made
without FMA contraction (tests/_caustic.py), its bucket overflow and grid
resolution equal.  The JAX render compiles for ~100 s, so this file holds
it alone.
"""

import numpy as np
import torch

import _caustic

torch.set_num_threads(2)


def test_caustic_hair_sppm_matches_jax(tmp_path):
    """24x24, 2 iterations, depth 3: hair VPs take their deposit through the
    hair lobe, and the iterations' overflow doubles the bucket scan."""
    text = _caustic.scene_text("caustic_hair", 24, iterations=2, depth=3)
    want = _caustic.jax_renders({"sppm": (text, None)}, tmp_path)
    st = {}
    got = _caustic.port_render(text, tmp_path, "sppm", stats=st)
    img = want["sppm"]
    assert got.shape == img.shape == (24, 24, 3) and np.isfinite(got).all()
    assert img.mean() > 0.01
    np.testing.assert_allclose(got, img, rtol=2e-3, atol=2e-3)
    assert st["grid_bucket_overflow"] == int(want["sppm:grid_bucket_overflow"]) > 0
    assert st["grid_res_last"] == int(want["sppm:grid_res_last"])
    assert st["max_ev_last"] == 64 and st["camera_rays"] == 24 * 24 * 2
