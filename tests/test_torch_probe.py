"""The gather probe's kernels P1 and P2 (rs_pbrt_tpu_torch/ops/gather_probe.py)
against the bodies of the JAX probe's Pallas kernels (tools/tpu_probe.py:110-141,
defined inside its main(), so written out here as they are there), run in
JAX on the CPU at the probe's shape (16, 2048) and 1000 steps.

Tolerance: none; the results must be bit-equal, including the steps where
the int32 product idx * 1103515245 wraps (it does for every idx above 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu_torch.ops import gather_probe as gp
from rs_pbrt_tpu_torch.tools import probe

torch.set_num_threads(2)

C = 2048


def jax_kern(tab, idx):  # tools/tpu_probe.py:110-113
    return jnp.take_along_axis(tab, idx, axis=1)


def jax_kern_loop(tab, idx, steps=1000):  # tools/tpu_probe.py:132-141
    def body(i, c):
        idx, acc = c
        g = jnp.take_along_axis(tab, idx, axis=1)
        idx = jax.lax.rem(idx * 1103515245 + 12345, C)
        idx = jnp.where(idx < 0, idx + C, idx)
        return idx, acc + g

    _, acc = jax.lax.fori_loop(0, steps, body, (idx, jnp.zeros_like(tab)))
    return acc


def inputs():
    tab, idx = gp.probe_inputs(16, C, seed=0, device="cpu")
    return tab, idx, jnp.asarray(tab.numpy()), jnp.asarray(idx.numpy())


def test_take_rows_matches_jax():
    tab, idx, jtab, jidx = inputs()
    got = gp.take_rows(tab, idx).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax_kern)(jtab, jidx)))
    np.testing.assert_array_equal(got, np.take_along_axis(tab.numpy(), idx.numpy(), 1))


def test_take_loop_matches_jax():
    tab, idx, jtab, jidx = inputs()
    before = dict(gp.launches)
    got = gp.take_loop(tab, idx).numpy()
    assert gp.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax_kern_loop)(jtab, jidx)))


def test_lcg_step_wraps_as_int32():
    """The index update on the indices the loop meets, against numpy int32
    arithmetic (which wraps) and lax.rem."""
    rng = np.random.default_rng(3)
    idx = np.concatenate([np.arange(C), rng.integers(0, C, 4096)]).astype(np.int32)
    with np.errstate(over="ignore"):
        raw = idx * np.int32(1103515245) + np.int32(12345)
    assert (raw < 0).any()  # the product wraps
    want = np.fmod(raw, C)
    want = np.where(want < 0, want + C, want)
    got = gp.lcg_step(torch.as_tensor(idx), C).numpy()
    np.testing.assert_array_equal(got, want)
    jwant = jax.lax.rem(jnp.asarray(idx) * 1103515245 + 12345, C)
    np.testing.assert_array_equal(got, np.asarray(jnp.where(jwant < 0, jwant + C, jwant)))


def test_probe_tool_runs_on_cpu(capsys):
    """All three parts of the probe at a small table, P1 equal to its plain
    version; the times are the CPU's host clock, labelled so."""
    res = probe.main("cpu", table_rows=4096, lanes=(256, 1024), widths=(8,))
    assert res["p1_equal"] and res["p2_row_fetches_per_s"] > 0
    out = capsys.readouterr().out
    assert "probe on cpu" in out and "P2 gather loop" in out


def test_wrappers_refuse_bad_cuda_inputs():
    """The checks the kernels rely on; they raise before any launch."""
    with pytest.raises(ValueError, match="CUDA"):
        gp._check("take_rows", torch.zeros(2, 2), torch.zeros(2, 2, dtype=torch.int32))


@pytest.mark.parametrize("steps", [0, 1, 7])
def test_take_loop_steps_match_jax(steps):
    """take_loop on the CPU at the step counts that leave the kernel's
    8-step jump-ahead a tail (or nothing), against the JAX fori_loop body.
    Tolerance: none."""
    tab, idx, jtab, jidx = inputs()
    got = gp.take_loop(tab, idx, steps).numpy()
    want = np.asarray(jax.jit(jax_kern_loop, static_argnums=2)(jtab, jidx, steps))
    np.testing.assert_array_equal(got, want)
    if steps == 0:
        assert not got.any()


def _wrap_i32(x):
    """int64 values cut to int32 with wraparound."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


@pytest.mark.parametrize("cols", [1, 2, 16, 32, 2048, 1 << 20])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_lcg_jump_equals_k_steps(k, cols):
    """The power-of-two path's jump, x -> (A_k x + B_k) & (C - 1) in uint32,
    equals k applications of lcg_step for every start index (65,536 random
    ones at 2^20); so does the byte offset the kernel keeps, o -> (A_k o +
    4 B_k) & (4C - 1) for o = 4x, with the constants the wrapper hands the
    kernel (_JUMP_ARG).  Tolerance: none."""
    a, b = gp.lcg_jump(k)
    x = np.arange(cols) if cols <= 2048 else \
        np.random.default_rng(k).choice(cols, 65536, replace=False)
    want = torch.as_tensor(x.astype(np.int32))
    for _ in range(k):
        want = gp.lcg_step(want, cols)
    want = want.numpy().astype(np.int64)
    x = x.astype(np.int64)
    np.testing.assert_array_equal(((a * x + b) & 0xFFFFFFFF) & (cols - 1), want)
    a_arg, b4_arg = gp._JUMP_ARG[2 * (k - 1)], gp._JUMP_ARG[2 * k - 1]
    assert (a_arg, b4_arg) == (a, 4 * b & 0xFFFFFFFF)
    np.testing.assert_array_equal(((a_arg * 4 * x + b4_arg) & 0xFFFFFFFF) & (4 * cols - 1),
                                  4 * want)


def rem_by_magic(v, cols):
    """The general path's remainder as csrc/gather_probe.cu computes it
    (lcg_rem), in int32 arithmetic with wraparound: q = ((mulhi(mul, v) +
    (v & add)) >> shift) + (v < 0), then v - q * cols."""
    mul, shift, add = gp.rem_magic(cols)
    v = v.astype(np.int64)
    hi = _wrap_i32(((v * mul) >> 32) + (v & add))
    q = _wrap_i32((hi >> shift) + ((v & 0xFFFFFFFF) >> 31))
    return _wrap_i32(v - q * cols)


@pytest.mark.parametrize("cols", [1, 2, 3, 7, 641, 2000, 2047, 2048, 58111])
def test_rem_magic_matches_fmod(cols):
    """The multiplier and shift the wrapper hands the kernel give the
    truncating remainder, torch.fmod, on the int32 edge values (-2^31, -1,
    0, 1, 2^31 - 1, multiples of C near both ends and their neighbours)
    and on 100,000 random int32.  Tolerance: none."""
    lo, hi = -(1 << 31), (1 << 31) - 1
    k = np.array([hi // cols, -(-lo // cols), 0, 1, -1, 2, -2])
    near = (k[:, None] * cols + np.array([-1, 0, 1])).ravel()
    v = np.concatenate([[lo, lo + 1, -1, 0, 1, hi - 1, hi], near,
                        np.random.default_rng(cols).integers(lo, hi, 100_000, endpoint=True)])
    v = v[(v >= lo) & (v <= hi)].astype(np.int32)
    want = torch.fmod(torch.as_tensor(v), cols).numpy()
    np.testing.assert_array_equal(rem_by_magic(v, cols), want)
