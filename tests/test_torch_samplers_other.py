"""Halton through volpath, whitted and SPPM, and zerotwo through volpath, on
the Cornell box (zerotwo also in a scattering grid medium), against the
JAX package: volpath and whitted per lane, SPPM per pixel (its camera pass
draws with the iteration number as the sample number, past spp).
Tolerance: rtol = atol = 2e-3, the JAX results computed without FMA
contraction (tests/_samplerscene.py).
"""

import pytest
import torch

import _samplerscene as S

torch.set_num_threads(2)

HALTON = S.KINDS["halton"]
# volpath with zerotwo: its pair offsets (1, 3, 9), which only the paired
# kinds read, light and bsdf in the box, the phase direction in the grid
# medium
JOBS = {"volpath_halton": ("volpath", HALTON, 4, {}),
        "volpath_zerotwo": ("volpath", S.KINDS["zerotwo"], 4, {}),
        "volpath_zerotwo_medium": ("volpath", S.KINDS["zerotwo"], 3, {"scene": "grid_hetero"}),
        "whitted_halton": ("whitted", HALTON, 2, {}),
        "sppm_halton": ("sppm", HALTON, 2, {"iterations": S.SPPM_ITERATIONS})}


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    return S.jax_lanes(JOBS, tmp_path_factory.mktemp("samplers_other"))


@pytest.mark.parametrize("tag", list(JOBS))
def test_render_matches_jax(lanes, tag):
    S.check(JOBS, tag, lanes)
