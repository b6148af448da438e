"""The path integrator with the zerotwo, stratified, Halton and maxmin
samplers on the Cornell box, against the JAX package per lane.

These scenes take the general bounce (K2 and regeneration are Sobol'-only,
as in the JAX package).  The bounce dims follow the JAX package's routes:
Halton's static stack of dims at depth 5 (35 dims), its traced-dim route
clipped at dim 255 at depth 19 (133 dims, past the 128 it stacks), and
the other kinds' get_1d_dyn / get_2d_dyn.  Tolerance: rtol = atol = 2e-3
per lane, the JAX lanes computed without FMA contraction
(tests/_samplerscene.py).
"""

import pytest
import torch

import _samplerscene as S

torch.set_num_threads(2)

JOBS = {**{f"path_{name}": ("path", kind, 5, {}) for name, kind in S.KINDS.items()},
        "path_halton_deep": ("path", S.KINDS["halton"], 19, {})}


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    return S.jax_lanes(JOBS, tmp_path_factory.mktemp("samplers_path"))


@pytest.mark.parametrize("tag", list(JOBS))
def test_path_render_matches_jax(lanes, tag):
    S.check(JOBS, tag, lanes)


def test_halton_deep_route_clips():
    """Depth 19 draws 133 bounce dims: the traced route, one H1 block a
    bounce, with dims past 255 clipped (the JAX halton_sample_dyn)."""
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod

    cfg = smpl.make_sampler(smpl.HALTON, 4, (S.RES, S.RES))
    assert not smpl.traced_route(cfg, pathmod.DIMS_PER_BOUNCE * 5)
    assert smpl.traced_route(cfg, pathmod.DIMS_PER_BOUNCE * 19)
    ctx = smpl.make_ctx(cfg, torch.zeros((8, 2), dtype=torch.int64), torch.arange(8), True)
    deep = smpl.get_dims(cfg, ctx, 300, 7, pathmod.PAIRS, dyn=True)
    assert torch.equal(deep, smpl.get_dims(cfg, ctx, 255, 1, dyn=True).expand(-1, 7))


def test_general_bounce_passes_contiguous_rays(monkeypatch):
    """On a triangle-only scene the hit points are views of K5's record
    rows; the sweeps' kernels take only contiguous rays, so scene
    intersection hands them contiguous ones (the plain versions, run here,
    do not check)."""
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.scene import presets

    seen = []

    def contiguous_only(fn):
        def call(o, d, t_max, tris, n_tri):
            seen.append(o.is_contiguous() and d.is_contiguous() and t_max.is_contiguous())
            return fn(o, d, t_max, tris, n_tri)
        return call

    monkeypatch.setattr(ik, "any_sweep", contiguous_only(ik.any_sweep_plain))
    monkeypatch.setattr(ik, "full_sweep", contiguous_only(ik.full_sweep_plain))
    scene, camera = presets.cornell_box((4, 4), device="cpu")
    for integrator in ("path", "volpath", "directlighting"):
        rdr.render(scene, camera, rdr.RenderCfg(integrator, 2, 3, 1.0),
                   smpl.make_sampler(smpl.HALTON, 2, (4, 4)))
    assert len(seen) > 10 and all(seen)
