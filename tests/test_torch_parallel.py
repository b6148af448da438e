"""rs_pbrt_tpu_torch's sharding (parallel/mesh.py, parallel/distributed.py)
on the CPU: a world of 4 gloo ranks (tests/_shardworld.py) against the
port on one process and against the JAX package's sharded functions on a
4-device mesh.

- The Cornell box at 24x20, 4 spp, depth 3, Sobol' (tests/test_parallel.py's
  case): render(mesh=) at 4 ranks equals render bit for bit with the box
  filter and with a crop (each box-filtered pixel's samples are on one
  rank: its band of rows), and with the Mitchell filter within rtol 1e-4,
  atol 1e-5 (the JAX package's bar; a splat on a band's edge sums two
  ranks' taps); it matches the JAX render_sharded within 2e-3 (the
  megakernel-vs-general bound, tests/test_pallas.py:157-161).  A (2, 2)
  host mesh equals the 1-D mesh.
- The statue at 24x16 (subdivisions 4, its BVH): render_sharded with
  regeneration through 128 lanes equals the fixed-depth loop within rtol
  1e-5, atol 1e-6 (tests/test_parallel.py:154-180).
- BDPT within rtol 1e-4, atol 1e-5 of render_bdpt (the splats' sums
  reassociate), and 2e-3 of the JAX render_bdpt_sharded; SPPM of 2
  iterations within rtol 1e-3, atol 1e-4 of render_sppm and of the JAX
  render_sppm_sharded (the deposits' sums reassociate); MLT within 1e-5
  of render_mlt (the same draws, the splats' sums reassociate) and its mean
  within 0.5x of the JAX sharded MLT's (the two packages draw other random
  numbers, tests/test_parallel.py:128-140).
- geometry_sharded_intersect on 61 triangles and 256 rays
  (tests/test_distributed.py:51-79): valid and tri equal against the
  port's closest hit over the whole table (t bit-equal: each shard runs
  the same watertight test) and against the JAX function on a 4-device
  mesh, whose t is within rtol 1e-5: the JAX function sweeps with
  intersect_tris_brute, another form of the test, which
  tests/test_torch_intersect.py holds the port's sweep to at that bound
  (a grazing hit here differs by 2.2e-6).
- grad_loss(mesh=) of the mean at 8x8, 2 spp, depth 3: the loss and the
  gradient within rtol 1e-5 (atol 1e-5 x the largest |g|) of the single
  process's, so not 4 x too large, and within rtol 2e-3 of the JAX
  grad_loss(mesh=).
- Every rank returns the same results.  In this process: a world of one
  (render(mesh=make_mesh("cpu"))) equals render bit for bit for every
  integrator and the gradient; init_distributed() is False without the
  launcher's variables; make_host_mesh(3) raises where the world does not
  factor.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _shardworld as W
from _a25scene import JaxJobs
from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
from rs_pbrt_tpu_torch.parallel import distributed as pd
from rs_pbrt_tpu_torch.parallel import mesh as pm

torch.set_num_threads(2)

GRADS = ("loss", "mat_params", "light_emission", "tex_params", "tex_atlas")
SHARED = ("box", "mitchell", "crop", "host", "bdpt", "sppm", "mlt", "regen_on", "regen_off",
          "geom", "grad")


@pytest.fixture(scope="module", autouse=True)
def sides(tmp_path_factory):
    """The world of ranks and the JAX jobs, started before the file's first
    test."""
    world = W.World(tmp_path_factory.mktemp("world"))
    jax = JaxJobs(tmp_path_factory.mktemp("shard_jax"), W.SCRIPT)
    jax.start({"mlt": ("mlt", {})})
    jax.start({"sppm": ("sppm", {}), "geom": ("geom", {})})
    jax.start({"path": ("path", {}), "grad": ("grad", {}), "bdpt": ("bdpt", {})})
    yield world, jax
    world.close()
    jax.close()


@pytest.fixture(scope="module")
def ranks(sides):
    return sides[0].results()


@pytest.fixture(scope="module")
def jax_res(sides):
    return sides[1].results()


@pytest.fixture(scope="module")
def single():
    return W.port_cases()


def keys(name: str) -> list:
    return {"geom": [f"geom_{k}" for k in ("valid", "t", "tri", "b0", "b1")],
            "grad": [f"grad_{k}" for k in GRADS]}.get(name, [name])


def test_init_distributed_without_variables(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert pd.init_distributed("cpu") is False
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def world_of_one():
    """The cases through a world of one started in this process."""
    mesh = pm.make_mesh("cpu")
    try:
        assert mesh.size() == 1 and dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="do not factor"):
            pd.make_host_mesh(3, device="cpu")
        yield W.port_cases(mesh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["box", "mitchell", "crop", "bdpt", "sppm", "mlt", "grad"])
def test_world_of_one_equals_render(world_of_one, single, name):
    for k in keys(name):
        np.testing.assert_array_equal(world_of_one[k], single[k], err_msg=k)


def test_host_mesh_of_three_raises(ranks):
    assert all(bool(r["host3_raised"]) for r in ranks)
    assert all(bool(r["init_distributed"]) for r in ranks)  # True in a group


@pytest.mark.parametrize("name", SHARED)
def test_every_rank_gets_the_whole_result(ranks, name):
    for r in range(1, W.WORLD):
        for k in keys(name):
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("name", ["box", "crop", "mitchell"])
def test_path_matches_render(ranks, single, name):
    got, want = ranks[0][name], single[name]
    assert got.shape == (W.RES[1], W.RES[0], 3) and np.isfinite(got).all()
    if name == "mitchell":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    if name == "crop":
        assert (got[:2] == 0).all() and got.max() > 0


def test_host_mesh_equals_the_1d_mesh(ranks):
    np.testing.assert_array_equal(ranks[0]["host"], ranks[0]["box"])


def test_path_matches_jax(ranks, jax_res):
    np.testing.assert_allclose(ranks[0]["box"], jax_res["path:img"], rtol=2e-3, atol=2e-3)


def test_regen_equals_the_fixed_depth_loop(ranks):
    """Each rank's 192 paths stream through 128 lanes: the pool refills."""
    assert all(int(r["regen_iterations"]) >= 2 for r in ranks)
    on, off = ranks[0]["regen_on"], ranks[0]["regen_off"]
    assert np.isfinite(on).all() and on.max() > 0
    np.testing.assert_allclose(on, off, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_bdpt(ranks, single, jax_res, ref):
    got = ranks[0]["bdpt"]
    assert np.isfinite(got).all() and got.max() > 0
    if ref == "port":
        np.testing.assert_allclose(got, single["bdpt"], rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, jax_res["bdpt:img"], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_sppm(ranks, single, jax_res, ref):
    got = ranks[0]["sppm"]
    assert np.isfinite(got).all() and got.max() > 0
    want = single["sppm"] if ref == "port" else jax_res["sppm:img"]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_mlt(ranks, single, jax_res, ref):
    got = ranks[0]["mlt"]
    assert np.isfinite(got).all() and got.max() > 0
    if ref == "port":
        np.testing.assert_allclose(got, single["mlt"], rtol=1e-5, atol=1e-5)
    else:
        want = float(jax_res["mlt:img"].mean())
        assert abs(float(got.mean()) - want) < 0.5 * want


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_geometry_sharded_intersect(ranks, jax_res, ref):
    got = {k: ranks[0][f"geom_{k}"] for k in ("valid", "t", "tri")}
    if ref == "port":
        p0, p1, p2, o, d, t_max = W.geom_case()
        tris = torch.as_tensor(np.concatenate([p0, p1, p2], 1))
        hit = ik.closest_sweep_plain(torch.as_tensor(o), torch.as_tensor(d),
                                     torch.as_tensor(t_max), tris, tris.shape[0])
        want = {k: getattr(hit, k).numpy() for k in ("valid", "t", "tri")}
    else:
        want = {k: jax_res[f"geom:{k}"] for k in ("valid", "t", "tri")}
    v = want["valid"]
    assert v.any() and not v.all()
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["tri"][v], want["tri"][v])
    if ref == "port":  # the same watertight test of the same triangles
        np.testing.assert_array_equal(got["t"], want["t"])
    else:
        np.testing.assert_allclose(got["t"][v], want["t"][v], rtol=1e-5)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_grad_loss(ranks, single, jax_res, ref):
    rtol = 1e-5 if ref == "port" else 2e-3
    for k in GRADS:
        got = ranks[0][f"grad_{k}"]
        want = single[f"grad_{k}"] if ref == "port" else jax_res[f"grad:{k}"]
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=k)
    assert np.abs(ranks[0]["grad_mat_params"]).max() > 0
