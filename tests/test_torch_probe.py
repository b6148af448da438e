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


def jax_kern_loop(tab, idx):  # tools/tpu_probe.py:132-141
    def body(i, c):
        idx, acc = c
        g = jnp.take_along_axis(tab, idx, axis=1)
        idx = jax.lax.rem(idx * 1103515245 + 12345, C)
        idx = jnp.where(idx < 0, idx + C, idx)
        return idx, acc + g

    _, acc = jax.lax.fori_loop(0, 1000, body, (idx, jnp.zeros_like(tab)))
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
