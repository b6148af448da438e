"""rs_pbrt_tpu_torch's MLT (models/integrators/mlt.py, the samplers'
primary-sample-space override) against the JAX package's, on the same
draws.

- The PSS override: get_1d, get_2d, the traced-dim route, get_dims and
  get_camera_dims read column dim mod U of SampleCtx.pss, as the JAX
  get_1d and get_2d do, whatever the sampler's kind.
- The bootstrap on the JAX _bootstrap_chains' own draws (its uniform PSS
  vectors and pick uniforms, replayed from its key): b at rtol 1e-4 (a
  mean of 256 luminances, summed in another order), the same chain starts,
  and their evaluation (_eval_target, the full target) per lane at rtol =
  atol = 2e-3.
- _eval_target with depth_stratified on seeded PSS vectors per lane at
  2e-3.
- Four _mutation_steps from the JAX chain starts fed the same numpy draws:
  every accept decision equal, the chains' states and the film's splat
  layer within 2e-3.
- render.render(RenderCfg("mlt", ...)) finite and within the JAX MLT smoke
  test's ratio (0.6-1.6) of the port's path render; a crop window keeps
  the pixels outside it black and the stats filled.
The JAX side runs without FMA contraction in subprocesses
(tests/_bdptscene.py), the Cornell box at 8x8, depth 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _bdptscene as B
from _a25scene import JaxJobs
from rs_pbrt_tpu.models import samplers as jsmpl
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import mlt
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import film as filmmod

torch.set_num_threads(2)
pytestmark = pytest.mark.usefixtures("jax_side")

TOL = 2e-3
N = 256  # bootstrap samples and chains
STEPS = 4
SEED = 7
N_PSS = mlt.n_pss_for_depth(B.DEPTH)


def step_draws(k: int) -> dict:
    """Mutation k's uniforms (u_large, u_fresh, noise, u_accept), numpy f32."""
    rng = np.random.default_rng(40 + k)
    return dict(large=rng.uniform(size=N), fresh=rng.uniform(size=(N, N_PSS)),
                noise=rng.normal(size=(N, N_PSS)), accept=rng.uniform(size=N))


def strat_pss():
    return np.random.default_rng(9).uniform(size=(N, N_PSS)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    inputs = {f"mlt:u{k}_{name}": a.astype(np.float32) for k in range(STEPS)
              for name, a in step_draws(k).items()}
    inputs["strat:pss"] = strat_pss()
    jj = JaxJobs(tmp_path_factory.mktemp("mlt_jax"), B.SCRIPT)
    jj.start({"mlt": ("mlt", dict(depth=B.DEPTH, n=N, seed=SEED, steps=STEPS))}, inputs)
    jj.start({"strat": ("strat", dict(depth=B.DEPTH))}, inputs)
    yield jj
    jj.close()


def cornell():
    scene, camera = B.scene_of("cornell", "torch")
    return scene, camera, pathmod.PathCfg(B.DEPTH, 1.0), smpl.make_sampler(smpl.RANDOM, 1,
                                                                           (B.RES, B.RES))


def assert_eval(got, res, prefix: str):
    """An evaluation (lum, raster points, L, splat points, splat values)
    against the JAX one's arrays "prefix0".."prefix4" per lane."""
    for i, (g, name) in enumerate(zip(got, ("lum", "pf", "L", "sp", "sl"))):
        want = res[f"{prefix}{i}"]
        assert tuple(g.shape) == want.shape, name
        np.testing.assert_allclose(g.numpy(), want, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("kind", [smpl.SOBOL, smpl.RANDOM, smpl.ZEROTWO, smpl.HALTON])
def test_pss_override_reads_columns(kind):
    """Every draw of a context with pss reads its column dim mod U, no
    kernel, as the JAX get_1d and get_2d do."""
    rng = np.random.default_rng(1)
    pss = rng.uniform(size=(64, 11)).astype(np.float32)
    cfg = smpl.make_sampler(kind, 4, (8, 8))
    z = torch.zeros(64, dtype=torch.int64)
    ctx = smpl.SampleCtx(torch.zeros((64, 2), dtype=torch.int64), z, z, pss=torch.as_tensor(pss))
    jcfg = jsmpl.make_sampler(kind, 4, (8, 8))
    jz = jnp.zeros(64, jnp.uint32)
    jctx = jsmpl.SampleCtx(jnp.zeros((64, 2), jnp.int32), jz, jsmpl.u64.U64(jz, jz),
                           jnp.asarray(pss))
    for dim in (0, 1, 2, 5, 10, 11, 17, 40):
        np.testing.assert_array_equal(smpl.get_1d(cfg, ctx, dim).numpy(),
                                      np.asarray(jsmpl.get_1d(jcfg, jctx, dim)))
        np.testing.assert_array_equal(smpl.get_2d(cfg, ctx, dim).numpy(),
                                      np.asarray(jsmpl.get_2d(jcfg, jctx, dim)))
        np.testing.assert_array_equal(smpl.get_1d_dyn(cfg, ctx, dim).numpy(), pss[:, dim % 11])
    np.testing.assert_array_equal(smpl.get_dims(cfg, ctx, 9, 5).numpy(),
                                  pss[:, [9, 10, 0, 1, 2]])
    u_film, u_time, u_lens = smpl.get_camera_dims(cfg, ctx, ctx.pixel)
    np.testing.assert_array_equal(torch.cat([u_film, u_time[:, None], u_lens], 1).numpy(),
                                  pss[:, :5])
    assert smpl.with_dims(cfg, ctx, 2, 20) is ctx


def test_bootstrap_matches_jax(jax_side):
    """bootstrap_from on the JAX bootstrap's draws: b, the chain starts and
    their evaluation."""
    scene, camera, pcfg, cfg_s = cornell()
    res = jax_side.results("mlt")
    boot, u_pick = (torch.as_tensor(res[f"mlt:{k}"]) for k in ("boot", "u_pick"))
    assert tuple(boot.shape) == (N, N_PSS)
    b, pss, ev = mlt.bootstrap_from(scene, camera, pcfg, cfg_s, None, False, None, boot, u_pick)
    assert float(b) == pytest.approx(float(res["mlt:b"]), rel=1e-4)
    np.testing.assert_array_equal(pss.numpy(), res["mlt:pss"])
    assert_eval(ev, res, "mlt:ev")


def test_eval_target_stratified_matches_jax(jax_side):
    """The depth-stratified target per lane: each lane's one strategy,
    scaled by its depth's strategies and the depth pick."""
    scene, camera, pcfg, cfg_s = cornell()
    ev = mlt._eval_target(scene, camera, pcfg, cfg_s, torch.as_tensor(strat_pss()), None,
                          depth_stratified=True)
    res = jax_side.results("strat")
    assert_eval(ev, res, "strat:ev")
    assert float(ev[0].sum()) > 0.0


def test_mutation_steps_match_jax(jax_side):
    """Four mutations from the JAX chain starts, fed the same draws: the
    same accept decisions on every chain, the states and the splat layer
    within 2e-3."""
    scene, camera, pcfg, cfg_s = cornell()
    res = jax_side.results("mlt")
    pss = torch.as_tensor(res["mlt:pss"])
    ev = tuple(torch.as_tensor(res[f"mlt:ev{i}"]) for i in range(5))
    film = filmmod.make_film((B.RES, B.RES), "cpu")
    accepted = 0
    for k in range(STEPS):
        u = tuple(torch.as_tensor(a.astype(np.float32)) for a in step_draws(k).values())
        new, ev, film = mlt._mutation_step(scene, camera, pcfg, cfg_s, None, False, None, pss,
                                           ev, film, u)
        acc = (new != pss).any(-1)
        np.testing.assert_array_equal(acc.numpy(), res[f"mlt:acc{k}"], err_msg=f"step {k}")
        accepted += int(acc.sum())
        pss = new
        np.testing.assert_allclose(pss.numpy(), res[f"mlt:pss{k}"], rtol=TOL, atol=TOL)
        assert_eval(ev, res, f"mlt:ev{k}_")
    assert 0 < accepted < STEPS * N
    assert film.splatted
    np.testing.assert_allclose(film.splat.numpy(), res["mlt:splat"], rtol=TOL, atol=TOL)


def test_render_mlt_against_path():
    """render.render's MLT of the 10x10 Cornell box (the JAX smoke test's
    settings) is finite, non-negative and within 0.6-1.6 of the port's path
    render's mean; the seeded generator makes it repeatable."""
    from rs_pbrt_tpu_torch.scene import presets

    scene, camera = presets.cornell_box((10, 10), device="cpu")
    cfg = rdr.RenderCfg("mlt", 1, 3, 1.0, extra=dict(mutations_per_pixel=16, chains=512,
                                                      bootstrap_samples=2048))
    scfg = smpl.make_sampler(smpl.RANDOM, 1, (10, 10))
    stats = {}
    img = rdr.render(scene, camera, cfg, scfg, stats=stats)
    ref = rdr.render(scene, camera, rdr.RenderCfg("path", 16, 3, 1.0),
                     smpl.make_sampler(smpl.SOBOL, 16, (10, 10)))
    assert torch.isfinite(img).all() and (img >= 0).all()
    ratio = float(img.mean() / ref.mean())
    assert 0.6 < ratio < 1.6, ratio
    assert stats["mutations"] == 100 * 16 // 512 and stats["camera_rays"] == 100 * 16
    assert stats["mutations_per_s"] > 0 and stats["b"] > 0
    again = mlt.render_mlt(scene, camera, 16, 3, n_chains=512, n_bootstrap=2048)
    assert torch.equal(img, again)


def test_render_mlt_crop_and_stats():
    """A crop window: only its pixels take splats, the stats count its
    pixels (the JAX TestExoticCropStats' check)."""
    scene, camera = B.scene_of("cornell", "torch", res=12)
    cfg = rdr.RenderCfg("mlt", 2, 3, 1.0, crop=(0.25, 0.75, 0.25, 0.75),
                        extra=dict(mutations_per_pixel=4, chains=64, bootstrap_samples=256))
    stats = {}
    img = rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.RANDOM, 2, (12, 12)),
                     stats=stats)
    assert img.shape == (12, 12, 3)
    assert (img[:3] == 0).all() and (img[9:] == 0).all()
    assert (img[:, :3] == 0).all() and (img[:, 9:] == 0).all()
    assert float(img[3:9, 3:9].sum()) > 0
    assert stats["wall_s"] > 0 and stats["camera_rays"] == 36 * 4
    assert stats["resolution"] == (12, 12)
