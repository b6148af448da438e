"""rs_pbrt_tpu_torch's stateless hash RNG (utils/rng.py) and random sampler
(models/samplers.py) against the JAX package's, and a random-sampler path
render against the JAX render of the same scene.

Tolerances: the hash, its uniforms and the sampler's dims bit-equal (the
words are held in int64 and masked to 32 bits; the u32 -> f32 rounding is
numpy's); the render per pixel rtol = atol = 2e-3, the JAX render made
without FMA contraction (tests/_caustic.py says why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _caustic
from rs_pbrt_tpu.models import samplers as jsmpl
from rs_pbrt_tpu.utils import rng as jrng
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.utils import rng

torch.set_num_threads(2)

N_KEYS = 1 << 16


def _keys(n_keys, seed):
    """(n_keys, N_KEYS) uint32 keys, 0 and 0xFFFFFFFF among them."""
    k = np.random.default_rng(seed).integers(0, 1 << 32, size=(n_keys, N_KEYS),
                                             dtype=np.uint64).astype(np.uint32)
    k[:, 0], k[:, 1] = 0, 0xFFFFFFFF
    k[0, 2:4] = (0xFFFFFFFF, 0)
    return k


@pytest.mark.parametrize("n_keys", [1, 2, 4, 5])
def test_uniform_float_bit_equal(n_keys):
    k = _keys(n_keys, n_keys)
    want = np.asarray(jrng.uniform_float(*[jnp.asarray(x) for x in k]))
    got = rng.uniform_float(*[torch.as_tensor(x.astype(np.int64)) for x in k]).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.max() < 1.0 and got.min() >= 0.0
    want_u = np.asarray(jrng.uniform_u32(*[jnp.asarray(x) for x in k])).astype(np.int64)
    np.testing.assert_array_equal(
        rng.uniform_u32(*[torch.as_tensor(x.astype(np.int64)) for x in k]).numpy(), want_u)


def test_hash_words_and_int_keys():
    """hash_u32 and hash_combine on the extreme words; Python int keys give
    what tensors of them give."""
    k = _keys(2, 9)
    np.testing.assert_array_equal(rng.hash_u32(torch.as_tensor(k[0].astype(np.int64))).numpy(),
                                  np.asarray(jrng.hash_u32(jnp.asarray(k[0]))).astype(np.int64))
    np.testing.assert_array_equal(
        rng.hash_combine(torch.as_tensor(k[0].astype(np.int64)),
                         torch.as_tensor(k[1].astype(np.int64))).numpy(),
        np.asarray(jrng.hash_combine(jnp.asarray(k[0]), jnp.asarray(k[1]))).astype(np.int64))
    idx = torch.arange(1000)
    np.testing.assert_array_equal(
        rng.uniform_float(idx, 0xFFFFFFFF, 7, 0).numpy(),
        rng.uniform_float(idx, torch.full((1000,), 0xFFFFFFFF), torch.full((1000,), 7),
                          torch.zeros(1000, dtype=torch.int64)).numpy())
    # 0x846CA68B * x overflows int64 for large x: the low word stays right
    big = torch.tensor([0xFFFFFFFF, 0x80000000, 0xDEADBEEF])
    want = [(int(x) * 0x846CA68B) & 0xFFFFFFFF for x in big]
    assert rng._mul32(big, 0x846CA68B).tolist() == want


def _contexts(res=(24, 16), spp=3, seed=5):
    w, h = res
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1))
    snum = np.repeat(np.arange(spp), w * h)
    jcfg = jsmpl.make_sampler(jsmpl.RANDOM, spp, res, seed)
    jctx = jsmpl.make_ctx(jcfg, jnp.asarray(pix, jnp.int32), jnp.asarray(snum, jnp.uint32))
    cfg = smpl.make_sampler(smpl.RANDOM, spp, res, seed)
    ctx = smpl.make_ctx(cfg, torch.as_tensor(pix), torch.as_tensor(snum), frame_lt_spp=True)
    return jcfg, jctx, cfg, ctx


def test_random_get_1d_2d_bit_equal():
    jcfg, jctx, cfg, ctx = _contexts()
    assert cfg.spp == jcfg.spp == 3  # the random sampler keeps spp
    for dim in (0, 1, 2, 5, 11, 40):
        want = np.asarray(jsmpl.get_1d(jcfg, jctx, dim))
        np.testing.assert_array_equal(smpl.get_1d(cfg, ctx, dim).numpy(), want)
        np.testing.assert_array_equal(smpl.get_2d(cfg, ctx, dim).numpy(),
                                      np.asarray(jsmpl.get_2d(jcfg, jctx, dim)))
    blk = smpl.with_dims(cfg, ctx, 5, 14)
    for dim in (5, 9, 18):
        np.testing.assert_array_equal(smpl.get_1d(cfg, blk, dim).numpy(),
                                      np.asarray(jsmpl.get_1d_dyn(jcfg, jctx, dim)))
    u_film, u_time, u_lens = smpl.get_camera_dims(cfg, ctx, ctx.pixel)
    jf, jt, jl = jsmpl.get_camera_dims(jcfg, jctx, jctx.pixel)
    for got, want in ((u_film, jf), (u_time, jt), (u_lens, jl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_path_render_matches_jax(tmp_path):
    """The caustic scene's geometry (glass sphere, matte floor, two point
    lights) with path and the random sampler at 24x24, 4 spp, depth 5."""
    text = _caustic.scene_text("caustic_only", 24, integrator="path", sampler="random", spp=4)
    want = _caustic.jax_renders({"path": (text, None)}, tmp_path)["path"]
    got = _caustic.port_render(text, tmp_path, "path")
    assert np.isfinite(got).all() and want.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_regeneration_stays_sobol_only():
    """The regeneration loop takes the Sobol' sampler only, as the JAX gate
    does (render.py:389-394); a random-sampler render through a tree takes
    the fixed-depth loop, and so does every other kind."""
    from rs_pbrt_tpu_torch.models.integrators import regen
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.tools import hair_scenes

    scene, _ = hair_scenes.fur_patch(64, resolution=(8, 8), device="cpu")
    accel = si.build_accel(scene, device="cpu")
    pcfg = pathmod.PathCfg(5, 1.0)
    assert regen.eligible(scene, pcfg, smpl.make_sampler(smpl.SOBOL, 4, (8, 8)), accel, 256,
                          lane_width=64)
    assert not regen.eligible(scene, pcfg, smpl.make_sampler(smpl.RANDOM, 4, (8, 8)), accel,
                              256, lane_width=64)
    for kind in (smpl.ZEROTWO, smpl.STRATIFIED, smpl.HALTON, smpl.MAXMIN):
        assert kind == getattr(jsmpl, ("ZEROTWO", "STRATIFIED", "HALTON", "MAXMIN")[kind - 2])
        assert not regen.eligible(scene, pcfg, smpl.make_sampler(kind, 4, (8, 8)), accel, 256,
                                  lane_width=64)
