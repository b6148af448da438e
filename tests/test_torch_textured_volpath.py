"""rs_pbrt_tpu_torch's volpath and SPPM on the texture grid
(tools/texture_scenes.py, its noise textures made constants,
tests/_texscene.py says why) against the JAX package: volpath per lane at
16x16, 2 spp, depth 3 on the same camera rays, differentials and Sobol'
indices, and SPPM's image (one iteration, depth 1), from a JAX subprocess
without FMA contraction of their own (test_torch_textured_render.py's
holds path, whitted, directlighting and ao).

Tolerances: per lane and per pixel rtol = atol = 2e-3
(test_torch_path_general.py's bound).
"""

import pytest
import torch

import _texscene as E

torch.set_num_threads(2)

TAGS = ("volpath", "sppm")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return E.jax_results(TAGS, tmp_path_factory.mktemp("textures_volpath"))


@pytest.mark.parametrize("tag", TAGS)
def test_render_matches_jax(tag, jax_results):
    E.check_render(tag, jax_results)
