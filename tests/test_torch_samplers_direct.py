"""The directlighting and ao integrators with the zerotwo, stratified,
Halton and maxmin samplers on the Cornell box, against the JAX package per
lane.

These integrators draw their dims through the JAX package's static get_1d
and get_2d: stratified's 2D draws come from its near-square stratum grid,
zerotwo's and maxmin's from the (0,2)-sequence, where path and volpath
take two 1D strata.  directlighting picks one light by power ("one") with
every kind, and samples every light ("all") with stratified; ao reads its
directions as 2D draws.  Tolerance: rtol = atol = 2e-3 per lane, the JAX
lanes computed without FMA contraction (tests/_samplerscene.py).
"""

import pytest
import torch

import _samplerscene as S

torch.set_num_threads(2)

JOBS = {**{f"dl_one_{name}": ("directlighting", kind, 2, {"sample_all": False})
           for name, kind in S.KINDS.items()},
        "dl_all_stratified": ("directlighting", S.KINDS["stratified"], 2, {"sample_all": True}),
        "ao_stratified": ("ao", S.KINDS["stratified"], 1, {"n_samples": 3}),
        "ao_maxmin": ("ao", S.KINDS["maxmin"], 1, {"n_samples": 3})}


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    return S.jax_lanes(JOBS, tmp_path_factory.mktemp("samplers_direct"))


@pytest.mark.parametrize("tag", list(JOBS))
def test_direct_render_matches_jax(lanes, tag):
    S.check(JOBS, tag, lanes)


@pytest.mark.parametrize("name", list(S.KINDS))
def test_every_integrator_renders_with_the_kind(name):
    """path, volpath, whitted, directlighting, ao and SPPM render the box
    with the kind through render.render on the CPU: a finite image that is
    not black (the per-lane references above cover the routes)."""
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.scene import presets

    scene, camera = presets.cornell_box((4, 4), device="cpu")
    for integrator in ("path", "volpath", "whitted", "directlighting", "ao", "sppm"):
        extra = dict(n_iterations=2) if integrator == "sppm" else None
        cfg = rdr.RenderCfg(integrator, 2, 2, 1.0, extra=extra)
        img = rdr.render(scene, camera, cfg, smpl.make_sampler(
            S.KINDS[name], 1 if integrator == "sppm" else 2, (4, 4)))
        assert img.shape == (4, 4, 3) and torch.isfinite(img).all(), integrator
        assert float(img.mean()) > 0.0, integrator
