"""rs_pbrt_tpu_torch's path radiance (K2's plain version, one call per
bounce) against the JAX package's general wavefront path,
path.radiance(mega=None), per lane on the same camera rays and Sobol'
indices.

Tolerance: rtol = atol = 2e-3 per lane and the mean within 1e-4 relative,
the bound the JAX package holds its own megakernel to against the general
path (tests/test_pallas.py:157-161): the same estimator and samples, with
float association as the only difference.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import cameras as jcam
from rs_pbrt_tpu.models import samplers as jsmpl
from rs_pbrt_tpu.models.integrators import path as jpath
from rs_pbrt_tpu.ops import pallas_path as jpp
from rs_pbrt_tpu.scene import presets as jpresets
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.ops import path_kernel as pk
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from test_torch_scene import build_hard

torch.set_num_threads(2)


def scenes(name):
    """(port scene, JAX scene, JAX camera)."""
    if name == "cornell":
        return (presets.cornell_box((16, 16), device="cpu")[0],) + jpresets.cornell_box((16, 16))
    if name == "cornell-52bit":
        return (presets.cornell_box((256, 256), device="cpu")[0],) + jpresets.cornell_box((256, 256))
    jcamera = jcam.make_perspective(jtr.look_at((0, 1.5, -6), (0, 0.8, 0), (0, 1, 0)), (12, 12),
                                   fov=60.0)
    return build_hard(SceneBuilder).finalize("cpu"), build_hard(JaxBuilder).finalize(), jcamera


def lanes(name, jcamera):
    """Pixels and sample numbers: the whole grid at 4 spp, or for the 52-bit
    case 512 random lanes of a 2^17-spp sampler (indices above 2^32)."""
    w, h = jcamera.resolution
    if name == "cornell-52bit":
        spp = 1 << 17
        rng = np.random.default_rng(52)
        pix = np.stack([rng.integers(0, w, 512), rng.integers(0, h, 512)], -1)
        return spp, pix, rng.integers(0, spp, 512)
    spp = 4
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1))
    return spp, pix, np.repeat(np.arange(spp), w * h)


def check_radiance(name):
    scene, jscene, jcamera = scenes(name)
    spp, pix, snum = lanes(name, jcamera)
    res = jcamera.resolution
    jcfg = jsmpl.make_sampler(jsmpl.SOBOL, spp, res)
    jctx = jsmpl.make_ctx(jcfg, jnp.asarray(pix, jnp.int32), jnp.asarray(snum, jnp.uint32),
                          frame_lt_spp=True)
    u_film, u_time, u_lens = jsmpl.get_camera_dims(jcfg, jctx, jctx.pixel)
    rays = jcam.generate_rays(jcamera, jctx.pixel.astype(jnp.float32) + u_film, u_lens, u_time)
    pcfg = jpath.PathCfg(max_depth=4, rr_threshold=1.0)
    want = np.asarray(jpath.radiance(jscene, pcfg, jcfg, jctx, rays.o, rays.d, None))

    cfg = smpl.make_sampler(smpl.SOBOL, spp, res)
    assert smpl.index_bits(cfg) == (52 if name == "cornell-52bit" else 32)
    ctx = smpl.make_ctx(cfg, torch.as_tensor(pix), torch.as_tensor(snum), frame_lt_spp=True)
    got = pathmod.radiance(scene, pathmod.PathCfg(4, 1.0), cfg, ctx,
                           torch.tensor(np.asarray(rays.o)), torch.tensor(np.asarray(rays.d))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert abs(got.mean() - want.mean()) < 1e-4 * max(want.mean(), 1e-6)
    assert want.mean() > 0.0


@pytest.mark.parametrize("name", ["cornell", "hard", "cornell-52bit"])
def test_radiance_matches_general_path(name):
    """cornell-52bit: a 2^17-spp sampler at 256x256 needs the 52-bit index
    (spp << 2*log2res > 2^32), the branch the flagship's 64 spp never takes."""
    check_radiance(name)


@pytest.mark.parametrize("max_depth", [0, 1, 5])
def test_launch_flags_match_jax(max_depth, monkeypatch):
    """Every bounce launch gets the JAX megakernel's static flags: the
    first-bounce and roulette switches, the emit-only last launch, the
    Sobol' rows (JAX counts them from DIM_CAMERA) and the index width.
    Both kernels are replaced by recorders, so nothing is rendered."""
    jscene, _ = jpresets.cornell_box((8, 8))
    scene, _ = presets.cornell_box((8, 8), device="cpu")
    seen_j, seen = [], []

    def fake_jax(lanes, idx2, *tables_cfg, **_):
        cfg, first, rr, emit, _thr, row0, bits = tables_cfg[6:13]
        seen_j.append((first, rr, emit, None if emit else jpath.DIM_CAMERA + row0, bits))
        return lanes

    def fake(lanes, alive, index, tables, cfg, **kw):
        emit = kw["emit_only"]
        seen.append((kw["first_bounce"], kw["rr_active"], emit,
                     None if emit else kw["dim_row"], kw["n_bits"]))
        return lanes, alive

    monkeypatch.setattr(jpp, "_bounce_call", fake_jax)
    monkeypatch.setattr(pk, "bounce", fake)
    pcfg = jpath.PathCfg(max_depth, 1.0)
    n = 64
    zeros = jnp.zeros(n, jnp.uint32)
    jpp.mega_radiance(jscene, jpp.mega_cfg(jscene), pcfg, zeros, zeros, jpath.DIM_CAMERA, 32,
                      jnp.zeros((n, 3)), jnp.ones((n, 3)))
    pk.mega_radiance(scene, pk.mega_cfg(scene), max_depth, 1.0, torch.zeros(n, dtype=torch.int64),
                     32, pathmod.DIM_CAMERA, torch.zeros(n, 3), torch.ones(n, 3))
    assert seen == seen_j
    assert len(seen) == max_depth + 1


def random_lanes(seed, n, dead=0.0):
    """Lane state in the Cornell box: origins inside it, random unit
    directions, beta in [0.05, 1), L in [0, 0.5), prev_pdf 1; a `dead`
    share of the lanes dead.  (lanes, alive, index)."""
    rng = np.random.default_rng(seed)
    lanes = torch.zeros(pk.N_LANE_ROWS, n)
    lanes[0:3] = torch.as_tensor(rng.uniform(50, 500, (3, n)), dtype=torch.float32)
    lanes[3:6] = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(3, n)),
                                                               dtype=torch.float32), dim=0)
    lanes[6:9] = torch.as_tensor(rng.uniform(0.05, 1.0, (3, n)), dtype=torch.float32)
    lanes[9:12] = torch.as_tensor(rng.uniform(0.0, 0.5, (3, n)), dtype=torch.float32)
    lanes[12] = 1.0
    alive = torch.as_tensor(rng.uniform(size=n) >= dead, dtype=torch.int32)
    return lanes, alive, torch.as_tensor(rng.integers(0, 1 << 20, n))


def test_bounce_wrapper_takes_plain_on_cpu():
    """On CPU tensors the wrapper is the plain version, and counts nothing."""
    scene, camera = presets.cornell_box((8, 8), device="cpu")
    cfg, tables = pk.mega_cfg(scene), pk.mega_tables(scene)
    lanes, alive, index = random_lanes(4, 256)
    kw = dict(dim_row=5, n_bits=32, first_bounce=True, rr_active=False, emit_only=False,
              rr_threshold=1.0)
    before = pk.launches
    want = pk.bounce_plain(lanes, alive, index, tables, cfg, **kw)
    got = pk.bounce(lanes, alive, index, tables, cfg, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert pk.launches == before


def test_mega_tables_flag_non_finite_vertices():
    """mega_tables marks a table whose vertices are all finite (the
    kernel's sweeps may then pick the sheared components by index) and
    clears the mark for an infinite or NaN vertex coordinate."""
    scene, _ = presets.cornell_box((8, 8), device="cpu")
    assert pk.mega_tables(scene).finite_verts
    for bad in (float("inf"), float("nan")):
        tri_attr = scene.tri_attr.clone()
        tri_attr[3, 7] = bad
        assert not pk.mega_tables(dataclasses.replace(scene, tri_attr=tri_attr)).finite_verts
    tri_attr = scene.tri_attr.clone()
    tri_attr[3, 20] = float("inf")  # not a vertex coordinate
    assert pk.mega_tables(dataclasses.replace(scene, tri_attr=tri_attr)).finite_verts


@pytest.mark.parametrize("emit_only", [False, True], ids=["bounce", "emit-only"])
def test_bounce_updates_in_place(emit_only):
    """The wrapper writes bounce_plain's result into the tensors it is
    given and returns them; bounce_plain leaves its inputs alone; the rows
    of the lanes that enter dead come out unchanged bit for bit."""
    scene, _ = presets.cornell_box((8, 8), device="cpu")
    cfg, tables = pk.mega_cfg(scene), pk.mega_tables(scene)
    lanes, alive, index = random_lanes(6, 512, dead=0.3)
    kw = dict(dim_row=26, n_bits=32, first_bounce=False, rr_active=True, emit_only=emit_only,
              rr_threshold=1.0)
    lanes0, alive0 = lanes.clone(), alive.clone()
    want = pk.bounce_plain(lanes, alive, index, tables, cfg, **kw)
    assert torch.equal(lanes, lanes0) and torch.equal(alive, alive0)
    got = pk.bounce(lanes, alive, index, tables, cfg, **kw)
    assert got[0] is lanes and got[1] is alive
    assert torch.equal(lanes, want[0]) and torch.equal(alive, want[1])
    dead = alive0 == 0
    assert 100 < int(dead.sum()) < 200
    assert torch.equal(lanes[:, dead].view(torch.int32), lanes0[:, dead].view(torch.int32))
    assert not alive[dead].any()
    live = ~dead
    assert not torch.equal(lanes[:, live], lanes0[:, live])  # the live lanes moved on


def test_curtain_scene_is_a_large_bounce_table():
    """tools/k2_replay's curtain scene is taken by the bounce kernel with a
    table above SHARED_TABLE_MAX_TRIS (its sweeps read it from device
    memory), all vertices finite; its recorded launches are one per bounce
    and the emit-only one, and a replayed launch through the wrapper equals
    bounce_plain on the same inputs."""
    from rs_pbrt_tpu_torch.tools import k2_replay

    scene, camera = k2_replay.curtain_scene((4, 4), device="cpu")
    cfg = pk.mega_cfg(scene)
    assert cfg is not None and cfg.n_tri == 2028
    assert pk.SHARED_TABLE_MAX_TRIS < cfg.n_tri <= pk.MEGA_MAX_TRIS
    assert pk.mega_tables(scene).finite_verts
    calls = k2_replay.record_launches(scene, camera, spp=1, depth=1)
    assert [c[5]["emit_only"] for c in calls] == [False, True]
    assert all(c[0].shape == (pk.N_LANE_ROWS, 16) for c in calls)
    assert int(calls[0][1].sum()) == 16  # every camera ray starts alive
    assert k2_replay.check_launch(calls[1]) == 0.0


def test_bounce_work_counts():
    """The lane counts bounce_plain reports for K2's bound (chip_smoke.py)
    agree with its outputs and with a per-lane count of the shadow tests,
    and asking for them changes nothing."""
    from rs_pbrt_tpu_torch.ops import watertight as wt

    scene, _ = presets.cornell_box((8, 8), device="cpu")
    cfg, tables = pk.mega_cfg(scene), pk.mega_tables(scene)
    rng = np.random.default_rng(5)
    n = 512
    lanes = torch.zeros(pk.N_LANE_ROWS, n)
    lanes[0:3] = torch.as_tensor(rng.uniform(50, 500, (3, n)), dtype=torch.float32)
    lanes[3:6] = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(3, n)),
                                                               dtype=torch.float32), dim=0)
    lanes[6:9] = torch.as_tensor(rng.uniform(0.05, 1.0, (3, n)), dtype=torch.float32)
    lanes[12] = 1.0
    alive = torch.as_tensor(rng.uniform(size=n) > 0.1, dtype=torch.int32)
    index = torch.as_tensor(rng.integers(0, 1 << 20, n))
    kw = dict(dim_row=26, n_bits=32, first_bounce=False, rr_active=True, emit_only=False,
              rr_threshold=1.0)
    work = {}
    got = pk.bounce_plain(lanes, alive, index, tables, cfg, **kw, work=work)
    want = pk.bounce_plain(lanes, alive, index, tables, cfg, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert work["live"] == int(alive.sum()) >= work["hit"] >= work["cont"] > 0
    assert 0 < work["rr_keep"] <= int(got[1].sum()) < work["cont"]  # some lanes killed
    assert 0 < work["unoccluded"] < work["shadow"] <= work["hit"]
    assert work["shadow"] < work["shadow_tests"] < work["shadow"] * cfg.n_tri
    assert work["hit_normals"] == work["light_normals"] == 0  # no vertex normals

    # the shadow tests of random rays, per lane: up to the first occluder
    o = tuple(lanes[k] for k in range(3))
    d = tuple(lanes[3 + k] for k in range(3))
    mask = alive != 0
    rc = wt.ray_constants(o, d)
    hits = torch.stack([wt.watertight_tri_any(rc, tables.tris[t], 300.0)
                        for t in range(cfg.n_tri)]).numpy()
    first = np.where(hits.any(0), hits.argmax(0) + 1, cfg.n_tri)
    want_tests = int(first[mask.numpy()].sum())
    assert wt.any_sweep_tests(tables.tris, cfg.n_tri, o, d, 300.0, mask) == want_tests
    assert want_tests < int(mask.sum()) * cfg.n_tri

@pytest.mark.slow
@pytest.mark.parametrize("name", ["cornell", "hard"])
def test_bounce_matches_interpreted_tpu_kernel(name, monkeypatch):
    """One launch of each kind, per lane, against the JAX megakernel run in
    interpret mode: random origins inside the scene, random directions (so
    some lanes miss), random beta, L and prev_pdf, a tenth of the lanes
    dead.  Float rows within rtol = atol = 2e-3 (the TPU kernel converts
    Sobol' words through i32 halves, 1 ulp), alive equal."""
    from rs_pbrt_tpu.ops import lowdiscrepancy as jld
    from rs_pbrt_tpu.ops import sampling as jsmp
    from rs_pbrt_tpu.ops.pallas_intersect import LANE, pack_tri_attr

    monkeypatch.setenv("RS_PBRT_PALLAS_INTERPRET", "1")
    scene, jscene, _ = scenes(name)
    lo, hi = ((50, 50, 50), (500, 500, 500)) if name == "cornell" else ((-2.5, 0.1, -2.5),
                                                                         (2.5, 2.4, 2.5))
    rng = np.random.default_rng(7)
    n = 8192
    d = rng.normal(size=(3, n))
    rows = np.concatenate([rng.uniform(lo, hi, (n, 3)).T, d / np.linalg.norm(d, axis=0),
                           rng.uniform(0.2, 1.2, (3, n)), rng.uniform(0.0, 0.5, (3, n)),
                           rng.uniform(0.05, 1.0, (1, n))]).astype(np.float32)
    alive = (rng.uniform(size=n) > 0.1).astype(np.int32)
    index = rng.integers(0, 1 << 32, n)

    dist = jsmp.make_distribution_1d(jscene.light_power)
    n_l = jscene.n_lights
    lsel = jnp.zeros((2, n_l + 1)).at[0].set(dist.cdf).at[1, :n_l].set(
        dist.func / jnp.maximum(dist.func_int * n_l, 1e-30))
    tables = (pack_tri_attr(jscene.tri_attr), jscene.light_attr, lsel, jscene.alight_tri_cdf,
              jscene.mat_attr, jld.SOBOL_MATRICES_32[pathmod.DIM_CAMERA:pathmod.DIM_CAMERA + 28])
    tile = lambda a: jnp.asarray(a).reshape(-1, LANE)
    jlanes = [tile(r) for r in rows[:12]] + [tile(alive), tile(rows[12])]
    idx2 = [tile((index >> 32).astype(np.uint32)), tile((index & 0xFFFFFFFF).astype(np.uint32))]
    mega = jpp.mega_cfg(jscene)
    for first, rr, emit, row0 in ((True, False, False, 0), (False, True, False, 21),
                                  (False, False, True, 0)):
        jout = jpp._bounce_call(jlanes, idx2, *tables, mega, first, rr, emit, 1.0, row0, 32,
                                interpret=True)
        jout = [np.asarray(a).reshape(-1) for a in jout]
        got, got_alive = pk.bounce_plain(
            torch.as_tensor(rows), torch.as_tensor(alive), torch.as_tensor(index),
            pk.mega_tables(scene), pk.mega_cfg(scene), dim_row=pathmod.DIM_CAMERA + row0,
            n_bits=32, first_bounce=first, rr_active=rr, emit_only=emit, rr_threshold=1.0)
        want = np.stack(jout[:12] + [jout[13]])
        np.testing.assert_array_equal(got_alive.numpy(), jout[12])
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
        assert 0 < got_alive.sum() < alive.sum()  # some lanes hit, some miss or end
