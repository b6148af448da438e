"""rs_pbrt_tpu_torch's ambient-occlusion integrator
(models/integrators/direct.py ao_radiance) against the JAX package's
direct.ao_radiance on quadric_env's camera rays and Sobol' indices
(tests/_envscene.py: 16x16, 2 spp, the sky at 64 x 128, 8 samples), with
cosine and with uniform hemisphere sampling; the JAX package's oracle of
an open plane (tests/test_integrators.py:83-98, slow there, so only the
port renders here); and its dims drawn in launches of at most K1's 128.

Tolerances: per lane rtol = atol = 2e-3 (test_torch_path_general.py's
bound) against the JAX lanes computed without FMA contraction in a
subprocess; the open plane within 5% of pi (the JAX test's bound; ao has
no 1/pi, ao.rs:94); the drawn dims bit-equal.
"""

import numpy as np
import pytest
import torch

import _envscene as E
import _volpath as V
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import direct
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)

TAGS = ("ao_cos", "ao_uniform")


@pytest.fixture(scope="module")
def jax_lanes(tmp_path_factory):
    return E.jax_results(TAGS, tmp_path_factory.mktemp("ao"))


@pytest.mark.parametrize("tag", TAGS)
def test_ao_matches_jax(tag, jax_lanes):
    scene, _ = E.port_scene()
    scfg, ctx = V.sample_ctx(E.RES, E.SPP)
    acfg = direct.AOCfg(E.AO_SAMPLES, E.LANE_JOBS[tag][1]["cos_sample"])
    got = direct.ao_radiance(scene, acfg, scfg, ctx, torch.as_tensor(jax_lanes["o"]),
                             torch.as_tensor(jax_lanes["d"])).numpy()
    want = jax_lanes[tag]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert 0.2 < want.mean() < np.pi and (want == 0).any()  # occluded and escaping lanes
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_open_plane_is_pi():
    """An open plane (the camera's look-at off the quads' shared edge):
    every shadow ray escapes, and dot / pdf with cosine sampling is pi."""
    b = SceneBuilder()
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-100, 0, -100], [100, 0, -100], [100, 0, 100], [-100, 0, 100]])
    camera = cam.make_perspective(tr.look_at([0, 5, -10], [1.0, 0, 0], [0, 1, 0]), (9, 9),
                                  fov=40.0, device="cpu")
    img = rdr.render(b.finalize("cpu"), camera, rdr.RenderCfg("ao", 8, 1, 1.0),
                     smpl.make_sampler(smpl.SOBOL, 8, (9, 9))).numpy()
    np.testing.assert_allclose(img[4, 4], np.pi, rtol=0.05)


@pytest.mark.parametrize("n_samples,launches", [(64, [(5, 128)]), (65, [(5, 128), (133, 2)])])
def test_dims_in_k1_sized_launches(n_samples, launches, monkeypatch):
    """64 samples draw their 128 dims in one K1 launch, 65 in two; the
    dims are the ones each sample's get_2d reads."""
    scene, _ = E.port_scene()
    scfg, ctx = V.sample_ctx(4, 1)
    o = torch.tensor([[0.0, 1.5, 5.5]]).repeat(16, 1)
    d = torch.nn.functional.normalize(torch.tensor([[0.0, -0.4, -1.0]]), dim=-1).repeat(16, 1)
    calls, blocks = [], []
    sobol_dims = sk.sobol_dims
    monkeypatch.setattr(sk, "sobol_dims", lambda idx, dim0, n, bits: calls.append((dim0, n))
                        or blocks.append(sobol_dims(idx, dim0, n, bits)) or blocks[-1])
    L = direct.ao_radiance(scene, direct.AOCfg(n_samples, True), scfg, ctx, o, d)
    assert calls == launches and torch.isfinite(L).all()
    drawn = torch.cat(blocks, 1)
    want = torch.stack([smpl.get_1d(scfg, ctx, direct.DIM_CAMERA + k)
                        for k in range(2 * n_samples)], 1)
    assert torch.equal(drawn, want)
