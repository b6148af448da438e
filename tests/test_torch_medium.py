"""rs_pbrt_tpu_torch's media (ops/medium.py) and the plain versions of M1
and M2 (ops/medium_kernel.py delta_track_plain, ratio_track_plain) against
the JAX package's functions on the same inputs, made by numpy from a seed.

Tolerances: phase_hg, hg_sample_phase, homogeneous_tr, homogeneous_sample
and grid_density rtol 1e-5, atol 1e-6 (the same formulas; XLA's log, exp,
sin and cos and its einsum's association differ from torch's in an ulp);
tracking on a 16^3 and a 8x12x16 grid (two media, 20,000 rays): sampled
equal, the weights equal, t rtol 1e-5, atol 1e-6 and Tr atol 2e-6 (the
JAX mean of sigma_t, its point transform and its log round a step's
distance differently in ~1e-7; no collision flips).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models.integrators import volpath as jvol
from rs_pbrt_tpu.ops import medium as jmed
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.ops import medium as med
from rs_pbrt_tpu_torch.ops import medium_kernel as mk
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)

N = 20000
TABLES = ("med_grid", "med_w2m", "med_sigma_a", "med_sigma_s", "med_max_density")


def close(got, want, what, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(21)
    g = rng.uniform(-0.9, 0.9, N).astype(np.float32)
    g[:100] = rng.uniform(-5e-4, 5e-4, 100)  # |g| < 1e-3 samples isotropically
    return dict(g=g, cos=rng.uniform(-1, 1, N).astype(np.float32), wo=_unit(rng, N),
                u2=rng.uniform(size=(N, 2)).astype(np.float32),
                sa=rng.uniform(0.0, 2.0, (N, 3)).astype(np.float32),
                ss=rng.uniform(0.0, 2.0, (N, 3)).astype(np.float32),
                uc=rng.uniform(size=N).astype(np.float32),
                ud=rng.uniform(size=N).astype(np.float32),
                t_max=rng.uniform(0.01, 5.0, N).astype(np.float32))


def test_phase_functions(lanes):
    T = {k: torch.as_tensor(v) for k, v in lanes.items()}
    close(med.phase_hg(T["cos"], T["g"]), jmed.phase_hg(lanes["cos"], lanes["g"]), "phase_hg")
    wi, pdf = med.hg_sample_phase(T["wo"], T["u2"], T["g"])
    jwi, jpdf = jmed.hg_sample_phase(jnp.asarray(lanes["wo"]), jnp.asarray(lanes["u2"]),
                                     jnp.asarray(lanes["g"]))
    close(wi, jwi, "hg_sample_phase wi")
    close(pdf, jpdf, "hg_sample_phase pdf")
    assert torch.allclose(wi.norm(dim=-1), torch.ones(N), atol=1e-5)


def test_homogeneous(lanes):
    T = {k: torch.as_tensor(v) for k, v in lanes.items()}
    st = T["sa"] + T["ss"]
    close(med.homogeneous_tr(st, T["t_max"]),
          jmed.homogeneous_tr(jnp.asarray(st.numpy()), lanes["t_max"]), "homogeneous_tr")
    ms = med.homogeneous_sample(T["sa"], T["ss"], T["uc"], T["ud"], T["t_max"])
    jms = jmed.homogeneous_sample(*(jnp.asarray(lanes[k]) for k in ("sa", "ss", "uc", "ud",
                                                                    "t_max")))
    assert 0.1 < float(ms.sampled.float().mean()) < 0.9
    np.testing.assert_array_equal(ms.sampled.numpy(), np.asarray(jms.sampled))
    close(ms.t, jms.t, "t")
    close(ms.weight, jms.weight, "weight")


def media_scene(builder_cls):
    """Two grid media (16^3 and 8x12x16, seeded densities) and a triangle,
    built by either package's builder."""
    rng = np.random.default_rng(5)
    b = builder_cls()
    b.add_medium(sigma_a=(0.1, 0.2, 0.3), sigma_s=(0.5, 0.4, 0.3),
                 density_grid=rng.uniform(0, 1, (16, 16, 16)).astype(np.float32),
                 medium_to_world=tr.compose(tr.translate([-1, -1, -1]), tr.scale(2, 2, 2)))
    b.add_medium(sigma_a=(0.3,) * 3, sigma_s=(1.0,) * 3, g=0.2,
                 density_grid=rng.uniform(0, 2, (8, 12, 16)).astype(np.float32),
                 medium_to_world=tr.compose(tr.translate([-0.5, -1, -2]), tr.scale(1.5, 3, 2.5)))
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 5], [1, 0, 5], [0, 1, 5]])
    return b


@pytest.fixture(scope="module")
def media():
    """(port scene, JAX scene, rays as numpy): 20,000 rays in either
    medium, 90% of them tracking."""
    scene = media_scene(SceneBuilder).finalize("cpu")
    jscene = media_scene(JaxBuilder).finalize()
    rng = np.random.default_rng(6)
    rays = dict(mid=rng.integers(0, 2, N).astype(np.int32),
                in_med=rng.uniform(size=N) < 0.9,
                o=rng.uniform(-1.2, 1.2, (N, 3)).astype(np.float32), d=_unit(rng, N),
                t_max=rng.uniform(0.01, 4.0, N).astype(np.float32),
                key=np.arange(N, dtype=np.int32))
    return scene, jscene, rays


def test_media_tables_equal_jax_builder(media):
    scene, jscene, _ = media
    for k in TABLES + ("med_g",):
        np.testing.assert_array_equal(getattr(scene, k).numpy(), np.asarray(getattr(jscene, k)),
                                      err_msg=k)
    assert scene.has_grid and scene.med_grid.shape == (2, 16, 16, 16)
    # the smaller grid is padded with 0
    assert float(scene.med_grid[1, 8:].abs().max()) == 0.0


@pytest.mark.parametrize("k", [0, 1])
def test_grid_density(media, k):
    scene, jscene, rays = media
    D, H, W = 16, 16, 16
    grid = scene.med_grid[k]
    p = rays["o"] * 1.1  # a share of the points outside either cube
    got = med.grid_density(grid, scene.med_w2m[k], torch.as_tensor(p))
    want = jmed.grid_density(jscene.med_grid[k], jscene.med_w2m[k], jnp.asarray(p))
    assert float((got > 0).float().mean()) > 0.1 and float((got == 0).float().mean()) > 0.1
    close(got, want, f"grid_density {k}")
    # the stacked form, each lane its own medium, reads the same values
    mid = torch.full((N,), k, dtype=torch.int32)
    assert torch.equal(med.grid_density(scene.med_grid, scene.med_w2m, torch.as_tensor(p), mid),
                       got)
    assert grid.shape == (D, H, W)


def _tabs(scene):
    return [getattr(scene, k) for k in TABLES]


def test_delta_track_plain_matches_jax(media):
    scene, jscene, r = media
    work = {}
    T = {k: torch.as_tensor(v) for k, v in r.items()}
    sampled, t, weight = mk.delta_track_plain(*_tabs(scene), T["mid"], T["in_med"], T["o"],
                                              T["d"], T["t_max"], T["key"], 3, 0x517, work=work)
    jms = jvol._delta_track(jscene, jnp.asarray(r["mid"]), jnp.asarray(r["in_med"]),
                            jnp.asarray(r["o"]), jnp.asarray(r["d"]), jnp.asarray(r["t_max"]),
                            jnp.asarray(r["key"].astype(np.uint32)), jnp.int32(3), 0x517)
    assert 0.05 < float(sampled.float().mean()) < 0.5
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(jms.sampled))
    close(t, jms.t, "t")
    np.testing.assert_array_equal(weight.numpy(), np.asarray(jms.weight))
    assert not bool(sampled[~T["in_med"]].any()) and bool((t[~T["in_med"]] == 0).all())
    # the work the bound counts: draws, lookups and the distinct voxels read
    assert work["steps"] >= work["lookups"] > 0
    assert 0 < torch.unique(torch.cat(work["voxel_set"])).numel() <= 2 * 16 ** 3


def test_ratio_track_plain_matches_jax(media):
    scene, jscene, r = media
    T = {k: torch.as_tensor(v) for k, v in r.items()}
    tr_ = mk.ratio_track_plain(*_tabs(scene), T["mid"], T["in_med"], T["o"], T["d"], T["t_max"],
                               T["key"], 0x5AD, 0x517)
    want = jvol._ratio_track_tr(jscene, jnp.asarray(r["mid"]), jnp.asarray(r["in_med"]),
                                jnp.asarray(r["o"]), jnp.asarray(r["d"]),
                                jnp.asarray(r["t_max"]), jnp.asarray(r["key"].astype(np.uint32)),
                                0x5AD, 0x517)
    assert 0.1 < float(tr_.mean()) < 0.95
    close(tr_, want, "tr", atol=2e-6)
    assert bool((tr_[~T["in_med"]] == 1).all())


def test_wrappers_run_the_plain_versions_on_the_cpu(media):
    scene, _, r = media
    T = {k: torch.as_tensor(v) for k, v in r.items()}
    args = (*_tabs(scene), T["mid"], T["in_med"], T["o"], T["d"], T["t_max"], T["key"])
    before = dict(mk.launches)
    for got, want in zip(mk.delta_track(*args, 2, 0x517), mk.delta_track_plain(*args, 2, 0x517)):
        assert torch.equal(got, want)
    assert torch.equal(mk.ratio_track(*args, 0x5AD, 0x517),
                       mk.ratio_track_plain(*args, 0x5AD, 0x517))
    assert mk.launches == before == {"delta_track": 0, "ratio_track": 0, "ratio_track_grad": 0}
