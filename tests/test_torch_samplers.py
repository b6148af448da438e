"""rs_pbrt_tpu_torch's samplers (models/samplers.py) and low-discrepancy
functions (ops/lowdiscrepancy.py) against the JAX package's, for every
kind: zerotwo, stratified, Halton and maxmin beside Sobol' and random.

Tolerances: everything here is bit-equal.  The index math is integer (32-bit
words held in int64 and masked); the floats are one rounding each of the
same f32 operations in the same order (u32 -> f32 rounded to nearest, the
Halton digits' products, the strata's sums and quotients), none of which
XLA's CPU compiler can contract into an FMA, so the comparison runs in this
process.  The JAX package's dims are compared over dims 0-40, Halton's
traced-dim route also over dims 250-300 (clipped at 255), and with sample
numbers above spp, as SPPM passes them.  H1's per-lane math
(csrc/halton.cuh) is built for the host and held to the plain version.
"""

import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import samplers as jsmpl
from rs_pbrt_tpu.ops import lowdiscrepancy as jld
from rs_pbrt_tpu.utils import rng as jrng
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.ops import halton_kernel as hk
from rs_pbrt_tpu_torch.ops import lowdiscrepancy as ld
from rs_pbrt_tpu_torch.utils import rng

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "rs_pbrt_tpu_torch" / "csrc"
KINDS = {"zerotwo": smpl.ZEROTWO, "stratified": smpl.STRATIFIED, "halton": smpl.HALTON,
         "maxmin": smpl.MAXMIN}
N_LANES = 2048


def bits_equal(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


def words(n=3000, seed=0):
    """n 32-bit words, 0, 1 and 0xFFFFFFFF among them: (uint32, int64 tensor)."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w[:3] = (0, 1, 0xFFFFFFFF)
    return w, torch.as_tensor(w.astype(np.int64))


def test_tables_are_a_copy():
    orig = np.load(ROOT / "rs_pbrt_tpu" / "data" / "tables.npz")
    copy = np.load(ROOT / "rs_pbrt_tpu_torch" / "data" / "halton_tables.npz")
    assert sorted(copy.keys()) == ["c_max_min_dist", "prime_sums", "primes"]
    for k in copy.keys():
        assert copy[k].dtype == orig[k].dtype and np.array_equal(copy[k], orig[k]), k
    assert ld.PRIMES == tuple(int(p) for p in ld.HALTON_PRIMES[:5])


def test_pcg32_and_shuffle_bit_equal():
    for args in ((), (7, 3), (0x853C49E6748FEA9B, 12345)):
        a, b = rng.Pcg32(*args), jrng.Pcg32(*args)
        assert [a.uniform_uint32() for _ in range(500)] == [b.uniform_uint32() for _ in range(500)]
        assert ([a.uniform_uint32_bounded(k) for k in range(1, 300)]
                == [b.uniform_uint32_bounded(k) for k in range(1, 300)])
    for n_dims in (1, 2, 3):
        a, b = rng.Pcg32(), jrng.Pcg32()
        assert rng.shuffle(list(range(99)), a, n_dims) == jrng.shuffle(list(range(99)), b, n_dims)


def test_permutations_bit_equal():
    """The first 256 bases' permutations equal the JAX package's, and the
    grown host table's prefix is the smaller table."""
    got = ld.compute_radical_inverse_permutations(n_bases=256)
    want = jld.compute_radical_inverse_permutations(n_bases=256)
    assert got.dtype == np.uint16 and np.array_equal(got, want)
    small = ld.compute_radical_inverse_permutations(n_bases=40)
    assert np.array_equal(small, got[:len(small)])
    table = ld.halton_permutations(300)
    assert np.array_equal(table[:len(got)], got)
    table = ld.halton_perms("cpu", 256).numpy().view(np.uint16)
    assert table[:len(got)].tolist() == got.tolist()
    assert ld.halton_perms("cpu", 3) is ld.halton_perms("cpu", 200)  # one copy a device


def test_lowdiscrepancy_functions_bit_equal():
    w, tw = words()
    s, ts = words(seed=1)
    bits_equal(ld.reverse_bits_32(tw), jld.reverse_bits_32(jnp.asarray(w)))
    bits_equal(ld.van_der_corput_sample(tw), jld.van_der_corput_sample(jnp.asarray(w)))
    bits_equal(ld.van_der_corput_sample(tw, ts),
               jld.van_der_corput_sample(jnp.asarray(w), jnp.asarray(s)))
    bits_equal(ld.sobol_02(tw, ts, ts ^ 0x5555), jld.sobol_02(
        jnp.asarray(w), jnp.asarray(s), jnp.asarray(s ^ np.uint32(0x5555))))
    bits_equal(ld.sobol_02(tw), jld.sobol_02(jnp.asarray(w)))
    for m in range(17):
        bits_equal(ld.max_min_dist_sample(tw, m), jld.max_min_dist_sample(jnp.asarray(w), m), m)
    bits_equal(ld.max_min_dist_sample(tw, 3, ts),
               jld.max_min_dist_sample(jnp.asarray(w), 3, jnp.asarray(s)))
    small = torch.as_tensor(np.arange(1 << 10))
    bits_equal(ld.max_min_dist_sample(small, 10, n_bits=10),
               jld.max_min_dist_sample(jnp.arange(1 << 10, dtype=jnp.uint32), 10))
    for nd in range(0, 9):
        bits_equal(ld.inverse_radical_inverse_2(tw, nd),
                   np.asarray(jld.inverse_radical_inverse_2(jnp.asarray(w), nd)))
        bits_equal(ld.inverse_radical_inverse_3(tw, nd),
                   np.asarray(jld.inverse_radical_inverse_3(jnp.asarray(w), nd)))


@pytest.mark.parametrize("exp_x,scale_y", [(0, 1), (3, 9), (7, 243)])
def test_halton_samples_bit_equal(exp_x, scale_y):
    """halton_samples (H1's plain version): the static route over dims 0-40
    against halton_sample, the traced route over dims 0-8 and 250-300
    against halton_sample_dyn (clipped to [2, 255])."""
    w, _ = words(2000, seed=exp_x)
    ja, tw = jnp.asarray(w), torch.as_tensor(w.view(np.int32))
    got = hk.halton_dims(tw, 0, 41, exp_x, scale_y)
    for d in range(41):
        bits_equal(got[:, d], jld.halton_sample(ja, d, exp_x, scale_y), d)
    for d0, n in ((0, 9), (250, 51)):
        got = hk.halton_dims(tw, d0, n, exp_x, scale_y, clip=True)
        for k in range(n):
            bits_equal(got[:, k], jld.halton_sample_dyn(ja, jnp.int32(d0 + k)), d0 + k)
    got = hk.halton_dims(tw, 120, 128, exp_x, scale_y)  # one launch's widest block
    for k in (0, 64, 127):
        bits_equal(got[:, k], jld.halton_sample(ja, 120 + k, exp_x, scale_y), 120 + k)


def test_halton_dims_wrapper_checks():
    w, tw64 = words(10)
    tw = torch.as_tensor(w.view(np.int32))
    before = hk.launches
    with pytest.raises(ValueError, match="int32"):
        hk.halton_dims(tw64, 0, 4, 3, 9)
    with pytest.raises(ValueError, match="n_dims"):
        hk.halton_dims(tw, 0, hk.MAX_DIMS + 1, 3, 9)
    with pytest.raises(ValueError, match="out of range"):
        hk.halton_dims(tw, 990, 20, 3, 9)
    with pytest.raises(ValueError, match="pixel scales"):
        hk.halton_dims(tw, 0, 4, 3, 0)
    hk.halton_dims(tw, 990, 20, 3, 9, clip=True)  # the clipped route reads bases below 256
    out = hk.halton_dims(tw, 2, 5, 3, 9)
    assert out.shape == (10, 5) and out.t().is_contiguous() and hk.launches == before


def _contexts(kind, res=(24, 16), spp=6, seed=5, above_spp=False):
    """(jcfg, jctx, cfg, ctx) of N_LANES random pixels of res and sample
    numbers below spp, or with above_spp half of them up to 4 spp (SPPM's
    iteration numbers; the context then makes no promise)."""
    g = np.random.default_rng(seed + kind)
    pix = np.stack([g.integers(0, res[0], N_LANES), g.integers(0, res[1], N_LANES)], -1)
    jcfg = jsmpl.make_sampler(kind, spp, res, seed)
    cfg = smpl.make_sampler(kind, spp, res, seed)
    snum = g.integers(0, cfg.spp, N_LANES)
    if above_spp:
        snum[::2] = g.integers(0, 4 * cfg.spp, N_LANES // 2)
    jctx = jsmpl.make_ctx(jcfg, jnp.asarray(pix, jnp.int32), jnp.asarray(snum, jnp.uint32),
                          not above_spp)
    ctx = smpl.make_ctx(cfg, torch.as_tensor(pix), torch.as_tensor(snum), not above_spp)
    return jcfg, jctx, cfg, ctx


@pytest.mark.parametrize("kind", [smpl.SOBOL, smpl.RANDOM, *KINDS.values()])
def test_make_sampler_and_index(kind):
    for spp, res in ((6, (24, 16)), (64, (256, 256)), (1, (1, 1)), (5, (200, 90))):
        cfg, jcfg = smpl.make_sampler(kind, spp, res, 9), jsmpl.make_sampler(kind, spp, res, 9)
        assert tuple(cfg) == tuple(jcfg)
    for above in (False, True):
        _, jctx, _, ctx = _contexts(kind, above_spp=above)
        want = jctx.global_index
        bits_equal(ctx.global_index, (np.asarray(want.hi).astype(np.int64) << 32)
                   | np.asarray(want.lo).astype(np.int64))


def test_make_sampler_raises_as_jax():
    with pytest.raises(ValueError, match="2\\^16"):
        smpl.make_sampler(smpl.MAXMIN, (1 << 16) + 1, (8, 8))
    with pytest.raises(ValueError, match="32-bit index"):
        smpl.make_sampler(smpl.HALTON, 1 << 18, (128, 128))
    smpl.make_sampler(smpl.HALTON, (1 << 32) // (128 * 243) - 1, (128, 128))
    with pytest.raises(ValueError, match="unknown sampler kind"):
        smpl.make_sampler(6, 4, (8, 8))


@pytest.mark.parametrize("kind", KINDS.values(), ids=KINDS.keys())
def test_dims_match_jax(kind):
    """get_1d, get_2d, get_1d_dyn and get_2d_dyn over dims 0-40 (Halton's
    traced route also over 250-300), and get_camera_dims, on lanes with
    sample numbers below spp and above it."""
    jcfg, jctx, cfg, ctx = _contexts(kind, above_spp=True)
    dims = list(range(41)) + (list(range(250, 301, 5)) if kind == smpl.HALTON else [])
    for dim in dims:
        if dim <= 40:
            bits_equal(smpl.get_1d(cfg, ctx, dim), jsmpl.get_1d(jcfg, jctx, dim), ("1d", dim))
            bits_equal(smpl.get_2d(cfg, ctx, dim), jsmpl.get_2d(jcfg, jctx, dim), ("2d", dim))
        bits_equal(smpl.get_1d_dyn(cfg, ctx, dim), jsmpl.get_1d_dyn(jcfg, jctx, jnp.int32(dim)),
                   ("1d_dyn", dim))
        bits_equal(smpl.get_2d_dyn(cfg, ctx, dim), jsmpl.get_2d_dyn(jcfg, jctx, jnp.int32(dim)),
                   ("2d_dyn", dim))
    for got, want in zip(smpl.get_camera_dims(cfg, ctx, ctx.pixel),
                         jsmpl.get_camera_dims(jcfg, jctx, jctx.pixel)):
        bits_equal(got, want, "camera")


@pytest.mark.parametrize("kind", KINDS.values(), ids=KINDS.keys())
def test_get_dims_and_blocks_match_jax(kind):
    """get_dims with 2D pairs (the path integrator's bounce layout with
    subsurface, static and traced), and the reads of a with_dims block
    (directlighting's layout) through get_1d and get_2d, against the JAX
    package's draws one dim or pair at a time."""
    jcfg, jctx, cfg, ctx = _contexts(kind, spp=16)
    pairs = (1, 3, 8, 11, 13)
    for dyn in (False, True):
        got = smpl.get_dims(cfg, ctx, 5, 30, pairs, dyn=dyn)
        j1 = jsmpl.get_1d_dyn if dyn else jsmpl.get_1d
        j2 = jsmpl.get_2d_dyn if dyn else jsmpl.get_2d
        dim = lambda k: jnp.int32(5 + k) if dyn else 5 + k
        for k in range(30):
            if k in pairs:
                bits_equal(got[:, k:k + 2], j2(jcfg, jctx, dim(k)), ("pair", dyn, k))
            elif k - 1 not in pairs:
                bits_equal(got[:, k], j1(jcfg, jctx, dim(k)), ("1d", dyn, k))
    blk = smpl.with_dims(cfg, ctx, 12, 7, (1, 4))
    for dim in range(10, 22):
        bits_equal(smpl.get_1d(cfg, blk, dim), jsmpl.get_1d(jcfg, jctx, dim), ("blk 1d", dim))
        bits_equal(smpl.get_2d(cfg, blk, dim), jsmpl.get_2d(jcfg, jctx, dim), ("blk 2d", dim))


@pytest.mark.parametrize("n", [2, 3, 5, 16, 17, 64, 100])
def test_permute_is_a_permutation_as_jax(n):
    keys = torch.as_tensor(np.arange(40) * 0x9E3779B1 % (1 << 32))
    i = torch.arange(n)
    got = smpl._permute(i[:, None], n, keys[None, :])
    for c in range(40):
        assert sorted(got[:, c].tolist()) == list(range(n))
    want = jsmpl._permute(jnp.arange(n, dtype=jnp.uint32)[:, None], n,
                          jnp.asarray(keys.numpy().astype(np.uint32))[None, :])
    bits_equal(got, np.asarray(want).astype(np.int64))


@pytest.mark.skipif(shutil.which("g++") is None, reason="no host C++ compiler to build "
                    "halton.cuh")
def test_host_build_of_h1_is_bit_equal(tmp_path):
    """csrc/halton.cuh compiled for the host without FMA contraction gives
    the plain version's bits: the film dims, dims 2-40, and the clipped
    route's 250-300."""
    drv = tmp_path / "drv.cpp"
    drv.write_text(r'''
#include <cstdio>
#include <vector>
#define RS_HD inline
#include "halton.cuh"
template <class T> std::vector<T> rd(const char* f) {
  FILE* fp = fopen(f, "rb"); fseek(fp, 0, SEEK_END); long n = ftell(fp); fseek(fp, 0, SEEK_SET);
  std::vector<T> v(n / sizeof(T)); if (fread(v.data(), 1, n, fp) != (size_t)n) return {};
  fclose(fp); return v; }
int main() {
  auto idx = rd<unsigned>("idx.bin"); auto perms = rd<unsigned short>("perms.bin");
  auto codes = rd<int>("codes.bin"); auto offs = rd<int>("offs.bin"); auto meta = rd<int>("meta.bin");
  std::vector<float> out(codes.size() * idx.size());
  for (size_t k = 0; k < codes.size(); ++k)
    for (size_t i = 0; i < idx.size(); ++i)
      out[k * idx.size() + i] = codes[k] == 0 ? halton::film_x(idx[i], meta[0])
          : codes[k] == 1 ? halton::film_y(idx[i], (unsigned)meta[1])
          : halton::scrambled(idx[i], (unsigned)codes[k], perms.data() + offs[k]);
  FILE* fp = fopen("out.bin", "wb"); fwrite(out.data(), 4, out.size(), fp); fclose(fp);
}
''')
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-I", str(CSRC), str(drv),
                    "-o", str(tmp_path / "drv")], check=True, timeout=120)
    w, tw = words(4096, seed=2)
    w.tofile(tmp_path / "idx.bin")
    ld.halton_permutations(ld.HALTON_MAX_BASES).tofile(tmp_path / "perms.bin")
    for dim0, n, clip in ((0, 41, False), (250, 51, True), (0, 4, True)):
        dims = hk._dims(dim0, n, clip)
        np.where(dims < 2, dims, ld.HALTON_PRIMES[dims]).astype(np.int32).tofile(
            tmp_path / "codes.bin")
        np.where(dims < 2, 0, ld.PRIME_SUMS[dims]).astype(np.int32).tofile(tmp_path / "offs.bin")
        np.asarray([3, 9], np.int32).tofile(tmp_path / "meta.bin")
        subprocess.run([str(tmp_path / "drv")], check=True, cwd=tmp_path, timeout=120)
        got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(n, -1)
        want = hk.halton_dims_plain(tw, dim0, n, 3, 9, clip).t().numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
