"""rs_pbrt_tpu_torch's tabulated BSSRDF (ops/bssrdf.py) against the JAX
package's: the host tables bit-equal (the same numpy code), and the
render-time spline functions on inputs made by numpy from a seed.

The port's render-time functions take the scene's folded tables whole with
a row index per lane; the JAX functions here get each lane's row gathered.
Tolerance: rtol 1e-5, atol 1e-7 (the same formulas; the interval search
finds the same index, asserted equal, and XLA's association of the spline
sums differs in an ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import bssrdf as jbss
from rs_pbrt_tpu_torch.ops import bssrdf as bss

torch.set_num_threads(2)

N = 20000
MATERIALS = (((0.0011, 0.0024, 0.014), (2.55, 3.21, 3.77), 0.0, 1.33),
             ((0.3, 0.05, 0.9), (1.0, 2.0, 0.5), 0.4, 1.5))


@pytest.fixture(scope="module")
def tables():
    return [bss.make_material_tables(*m) for m in MATERIALS]


@pytest.mark.parametrize("m", range(len(MATERIALS)))
def test_material_tables_equal_jax(tables, m):
    want = jbss.make_material_tables(*MATERIALS[m])
    assert set(tables[m]) == set(want)
    for k, v in want.items():
        assert np.asarray(tables[m][k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(tables[m][k], v, err_msg=k)
    np.testing.assert_array_equal(bss.RADIUS_NODES, jbss.RADIUS_NODES)


@pytest.fixture(scope="module")
def lanes(tables):
    rng = np.random.default_rng(17)
    profile = np.stack([t["profile"] for t in tables])  # (B, 3, K)
    cdf = np.stack([t["cdf"] for t in tables])
    bid = rng.integers(0, len(tables), N)
    ch = rng.integers(0, 3, N)
    r_max = float(bss.RADIUS_NODES[-1])
    x = rng.uniform(0.0, 1.0, N) ** 4 * r_max * 1.05  # 5% past the grid's end
    x[:64] = bss.RADIUS_NODES  # exactly on the nodes
    x[64:70] = (-1.0, -1e-9, np.nan, r_max, np.inf, 0.0)
    sigma_t = np.stack([t["sigma_t"] for t in tables])[bid]
    sigma_t[:50, 1] = 0.0  # the sampling's sentinel
    return dict(profile=profile, cdf=cdf, bid=bid, ch=ch, row=bid * 3 + ch,
                x=x.astype(np.float32), sigma_t=sigma_t.astype(np.float32),
                rho_eff=np.stack([t["rho_eff"] for t in tables])[bid],
                r=(rng.uniform(0.0, 1.0, N) ** 3 * 3.0).astype(np.float32),
                u=rng.uniform(size=N).astype(np.float32),
                eta=rng.uniform(0.7, 2.0, N).astype(np.float32),
                cos=rng.uniform(-1.0, 1.0, N).astype(np.float32))


def close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7,
                               err_msg=what)


def test_cr_weights_and_spline_eval(lanes):
    x = torch.as_tensor(lanes["x"])
    valid, idx, w = bss._cr_weights(x)
    jvalid, jidx, jw = jbss._cr_weights(jbss.RADIUS_NODES, jnp.asarray(lanes["x"]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    finite = np.isfinite(lanes["x"])
    for k in range(4):
        close(w[k][finite], np.asarray(jw[k])[finite], f"w{k}")
    rows = torch.as_tensor(lanes["profile"].reshape(-1, bss.N_RADIUS))
    row = lanes["row"]
    got = bss.spline_eval(rows, torch.as_tensor(row), x)
    want = jbss.spline_eval(jnp.asarray(rows.numpy()[row]), jnp.asarray(lanes["x"]))
    assert float(got.abs().mean()) > 0
    close(got, want, "spline_eval")


def test_sr_and_pdf(lanes):
    T = {k: torch.as_tensor(v) for k, v in lanes.items()}
    got = bss.sr_eval(T["profile"], T["bid"], T["sigma_t"], T["r"])
    want = jbss.sr_eval(jnp.asarray(lanes["profile"][lanes["bid"]]), jnp.asarray(lanes["sigma_t"]),
                        jnp.asarray(lanes["r"]))
    assert float((got > 0).float().mean()) > 0.5
    close(got, want, "sr_eval")
    rows = T["profile"].reshape(-1, bss.N_RADIUS)
    for c in range(3):
        row = T["bid"] * 3 + c
        got = bss.pdf_sr_channel(rows, row, T["rho_eff"][:, c], T["sigma_t"][:, c], T["r"])
        want = jbss.pdf_sr_channel(jnp.asarray(rows.numpy()[row.numpy()]),
                                   jnp.asarray(lanes["rho_eff"][:, c]),
                                   jnp.asarray(lanes["sigma_t"][:, c]), jnp.asarray(lanes["r"]))
        close(got, want, f"pdf_sr_channel {c}")


def test_sample_sr_channel(lanes):
    T = {k: torch.as_tensor(v) for k, v in lanes.items()}
    prof = T["profile"].reshape(-1, bss.N_RADIUS)
    cdf = T["cdf"].reshape(-1, bss.N_RADIUS)
    sig = torch.gather(T["sigma_t"], 1, T["ch"][:, None])[:, 0]
    for u in (T["u"], torch.full_like(T["u"], 0.999)):
        got = bss.sample_sr_channel(prof, cdf, T["row"], sig, u)
        want = jbss.sample_sr_channel(jnp.asarray(prof.numpy()[lanes["row"]]),
                                      jnp.asarray(cdf.numpy()[lanes["row"]]),
                                      jnp.asarray(sig.numpy()), jnp.asarray(u.numpy()))
        assert bool((got[sig == 0] == -1).all()) and float((got > 0).float().mean()) > 0.9
        close(got, want, "sample_sr_channel")


def test_sw_factor(lanes):
    got = bss.sw_factor(torch.as_tensor(lanes["eta"]), torch.as_tensor(lanes["cos"]))
    want = jbss.sw_factor(jnp.asarray(lanes["eta"]), jnp.asarray(lanes["cos"]))
    close(got, want, "sw_factor")
