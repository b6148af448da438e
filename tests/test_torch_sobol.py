"""rs_pbrt_tpu_torch's Sobol' sampler and K1's plain version against the
JAX package.

The port carries the 52-bit global index as one int64 where the JAX
package splits it into u32 hi/lo words; the index must be equal to
hi << 32 | lo exactly.  sobol_dims_plain converts u32 -> f32 directly, as
lowdiscrepancy.sobol_sample does, so the two are bit-equal; the TPU kernel
(interpreted here) converts through i32 halves and agrees within 2^-24
(tests/test_pallas.py:94-116).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import samplers as jsmpl
from rs_pbrt_tpu.ops import lowdiscrepancy as jld
from rs_pbrt_tpu.ops import pallas_sobol as jps
from rs_pbrt_tpu.utils import u64
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.ops import lowdiscrepancy as ld
from rs_pbrt_tpu_torch.ops import sobol_kernel as sk

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def joined(idx: u64.U64) -> np.ndarray:
    return (np.asarray(idx.hi).astype(np.int64) << 32) | np.asarray(idx.lo).astype(np.int64)


def indices(bits: int, n: int = 300, seed: int = 3):
    """n random global indices below 2^bits, as int64 and as hi/lo words."""
    v = np.random.default_rng(seed).integers(0, 1 << bits, n, dtype=np.int64)
    hi = jnp.asarray((v >> 32).astype(np.uint32))
    lo = jnp.asarray((v & 0xFFFFFFFF).astype(np.uint32))
    return torch.as_tensor(v), u64.U64(hi, lo)


def test_tables_are_a_copy():
    orig = np.load(ROOT / "rs_pbrt_tpu" / "data" / "tables.npz")
    copy = np.load(ROOT / "rs_pbrt_tpu_torch" / "data" / "sobol_tables.npz")
    assert sorted(copy.keys()) == sorted(
        ["sobol_matrices_32", "vdc_lo", "vdc_hi", "vdc_inv_lo", "vdc_inv_hi"])
    for k in copy.keys():
        assert copy[k].dtype == orig[k].dtype and np.array_equal(copy[k], orig[k]), k


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("spp", [1, 16, 64])
def test_interval_to_index_exact(m, spp):
    rng = np.random.default_rng(m * 100 + spp)
    n = 257
    frame = rng.integers(0, spp, n).astype(np.uint32)
    pix = rng.integers(0, 1 << m, (n, 2)).astype(np.int32)
    want = joined(jld.sobol_interval_to_index(m, jnp.asarray(frame), jnp.asarray(pix)))
    got = ld.sobol_interval_to_index(m, torch.as_tensor(frame.astype(np.int64)),
                                     torch.as_tensor(pix))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spp,res", [(4, (16, 16)), (64, (256, 256)), (3, (20, 12))])
def test_make_ctx_index_exact(spp, res):
    """make_ctx with the batched-render promise (frame < spp) gives the JAX
    package's index; spp rounds up to a power of two in both."""
    jcfg = jsmpl.make_sampler(jsmpl.SOBOL, spp, res)
    cfg = smpl.make_sampler(smpl.SOBOL, spp, res)
    assert (cfg.spp, cfg.log2_resolution) == (jcfg.spp, jcfg.log2_resolution)
    rng = np.random.default_rng(spp)
    pix = np.stack([rng.integers(0, res[0], 500), rng.integers(0, res[1], 500)], -1)
    snum = rng.integers(0, cfg.spp, 500)
    jctx = jsmpl.make_ctx(jcfg, jnp.asarray(pix, jnp.int32), jnp.asarray(snum, jnp.uint32),
                          frame_lt_spp=True)
    ctx = smpl.make_ctx(cfg, torch.as_tensor(pix), torch.as_tensor(snum), frame_lt_spp=True)
    np.testing.assert_array_equal(ctx.global_index.numpy(), joined(jctx.global_index))


@pytest.mark.parametrize("bits", [32, 52])
def test_sobol_dims_plain_bit_equal(bits):
    index, jindex = indices(bits)
    got = sk.sobol_dims_plain(index, 2, 5, bits).numpy()
    want = np.stack([np.asarray(jld.sobol_sample(jindex, 2 + k)) for k in range(5)], -1)
    np.testing.assert_array_equal(got, want)
    for k in range(5):  # the single-dimension form too
        np.testing.assert_array_equal(ld.sobol_sample(index, 2 + k).numpy(), want[:, k])


@pytest.mark.parametrize("bits", [32, 52])
def test_sobol_dims_near_tpu_kernel(bits, monkeypatch):
    """Within 1 ulp of the JAX Sobol' kernel, run in interpret mode."""
    monkeypatch.setenv("RS_PBRT_PALLAS_INTERPRET", "1")
    index, jindex = indices(bits, seed=5)
    want = np.asarray(jps.sobol_dims(jindex.hi, jindex.lo, 7, 5, index_bits=bits))
    got = sk.sobol_dims(index, 7, 5, bits).numpy()  # a CPU tensor: the plain version
    assert np.abs(got - want).max() <= 2.0 ** -24


def test_camera_dims_match_jax():
    """get_camera_dims: dims 0-4 with the film dims remapped into the pixel."""
    cfg = smpl.make_sampler(smpl.SOBOL, 8, (32, 32))
    jcfg = jsmpl.make_sampler(jsmpl.SOBOL, 8, (32, 32))
    rng = np.random.default_rng(11)
    pix = rng.integers(0, 32, (400, 2))
    snum = rng.integers(0, 8, 400)
    jctx = jsmpl.make_ctx(jcfg, jnp.asarray(pix, jnp.int32), jnp.asarray(snum, jnp.uint32), True)
    ctx = smpl.make_ctx(cfg, torch.as_tensor(pix), torch.as_tensor(snum), True)
    got = smpl.get_camera_dims(cfg, ctx, ctx.pixel)
    want = jsmpl.get_camera_dims(jcfg, jctx, jctx.pixel)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sobol_dims_wrapper_checks():
    with pytest.raises(ValueError, match="unknown sampler kind"):
        smpl.make_sampler(jsmpl.MAXMIN + 1, 4, (8, 8))
    assert smpl.index_bits(smpl.make_sampler(smpl.SOBOL, 64, (256, 256))) == 32
    assert smpl.index_bits(smpl.make_sampler(smpl.SOBOL, 1 << 17, (256, 256))) == 52


@pytest.mark.parametrize("spp,res", [(1, (1, 1)), (2, (1, 1)), (3, (20, 12)), (16, (16, 16)),
                                     (64, (64, 64)), (8, (256, 256))])
def test_exact_width_bounds_every_index(spp, res):
    """Every global index of the whole pixel grid x spp, as the JAX
    package's make_ctx makes it with the batched-render promise, lies below
    2^exact_index_bits, and the width is tight (the largest index needs its
    top bit)."""
    cfg = smpl.make_sampler(smpl.SOBOL, spp, res)
    jcfg = jsmpl.make_sampler(jsmpl.SOBOL, spp, res)
    w, h = res
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (cfg.spp, 1))
    snum = np.repeat(np.arange(cfg.spp), w * h)
    jctx = jsmpl.make_ctx(jcfg, jnp.asarray(pix, jnp.int32), jnp.asarray(snum, jnp.uint32),
                          frame_lt_spp=True)
    top = int(joined(jctx.global_index).max())
    bits = smpl.exact_index_bits(cfg)
    assert top < 1 << bits and (bits == 1 or top >= 1 << (bits - 1))
    ctx = smpl.make_ctx(cfg, torch.as_tensor(pix), torch.as_tensor(snum), frame_lt_spp=True)
    assert ctx.frame_lt_spp and smpl.dims_bits(cfg, ctx) == bits
    # without the promise a context keeps the 32/52-bit width
    assert smpl.dims_bits(cfg, ctx._replace(frame_lt_spp=False)) == smpl.index_bits(cfg)


def test_exact_widths_of_the_render_paths():
    """22 bits at 256x256, 64 spp (the flagship, slice 2); 19 at 8 spp (the
    statue); spp rounds up to a power of two first."""
    width = lambda spp, res: smpl.exact_index_bits(smpl.make_sampler(smpl.SOBOL, spp, res))
    assert width(64, (256, 256)) == 22 and width(8, (256, 256)) == 19
    assert width(3, (20, 12)) == width(4, (32, 32)) == 12
    assert width(1 << 30, (1 << 15, 1 << 15)) == ld.SOBOL_MATRIX_SIZE


@pytest.mark.parametrize("dim0,bits", [(2, 19), (2, 22), (ld.NUM_SOBOL_DIMENSIONS - 128, 22),
                                       (ld.NUM_SOBOL_DIMENSIONS - 128, 52)])
def test_sobol_dims_plain_128_dims_bit_equal(dim0, bits):
    """128 dims (one K1 launch's most), among them the table's last, from
    the low `bits` bits of indices below 2^bits: bit-equal to the JAX
    package's sobol_sample."""
    index, jindex = indices(bits, n=200, seed=bits)
    got = sk.sobol_dims(index, dim0, sk.MAX_DIMS, bits)  # a CPU tensor: the plain version
    wide = u64.U64(jindex.hi[:, None], jindex.lo[:, None])
    want = np.asarray(jld.sobol_sample(wide, jnp.arange(dim0, dim0 + sk.MAX_DIMS)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sobol_dims_are_dims_major():
    """The plain version returns the kernel's layout: the transposed view of
    a (n_dims, N) tensor, so one dimension of every lane is contiguous."""
    index, _ = indices(22, n=50)
    got = sk.sobol_dims(index, 3, 7, 22)
    assert got.shape == (50, 7) and got.stride() == (1, 50)
    assert got[:, 4].is_contiguous() and got.t().is_contiguous()


@pytest.mark.parametrize("index_of,args,match", [
    (None, (0, 0, 22), "n_dims"), (None, (0, 129, 22), "n_dims"),
    (None, (-1, 5, 22), "out of range"), (None, (1000, 25, 22), "out of range"),
    (None, (0, 5, 0), "n_bits"), (None, (0, 5, 53), "n_bits"),
    (lambda i: i.to(torch.int32), (0, 5, 22), "int64"), (lambda i: i[::2], (0, 5, 22), "int64"),
])
def test_sobol_dims_wrapper_checks_run_on_cpu(index_of, args, match):
    """The wrapper's argument checks run before it picks the plain version
    for a CPU index, so they hold on the CPU as on the card."""
    index, _ = indices(22, n=10)
    with pytest.raises(ValueError, match=match):
        sk.sobol_dims(index_of(index) if index_of else index, *args)
    assert sk.sobol_dims(index, 1024 - 128, 128, 52).shape == (10, 128)
