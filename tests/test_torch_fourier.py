"""rs_pbrt_tpu_torch's Fourier BSDF (ops/fourier_bsdf.py: the host side and
the plain versions of F1 and F2, which the kernels' wrappers in
ops/fourier_kernel.py run on CPU tensors) against the JAX package's, and
the glossy table of tools/material_scenes.py against its analytic BRDF.

Tolerances: the plain f and pdf per lane rtol 1e-4, atol 1e-6 of the JAX
ones (the same formulas; XLA's fused multiply-adds differ in ulps); the
sample's wi within rtol 2e-3 on 99% of the lanes and within rtol 1e-5 on
95% (observed: 99.6% and 96.3% on the glossy table, all of them on the
Lambertian one): the 20 bracketed Newton steps in phi have not converged
on some lanes near the glossy peak, where an ulp of cos (torch's against
XLA's) moves where they end; f and pdf at every lane's sampled wi within
rtol 1e-4 of the JAX ones there; a SCATFUN v1 file read equal by both
packages; the glossy table at its nodes within its truncation (the orders
it cuts, summed, and 1e-4 of f for the azimuthal quadrature) (the channels
G derives from, twice the largest); sample and pdf consistent (the
Lambertian table's albedo by its own sampling within 2% of rho, and the
integral of cos^2 over the hemisphere, 2 pi / 3, estimated with F1's pdf
at the sampled directions within 2%).
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import fourier_bsdf as jfb
from rs_pbrt_tpu_torch.ops import fourier_bsdf as fb
from rs_pbrt_tpu_torch.ops import fourier_kernel as fk
from rs_pbrt_tpu_torch.tools import material_scenes as ms

torch.set_num_threads(2)

N = 512  # the plain sample is ~12,000 small ops a call


def device_table(tab):
    return fb.FourierTable(*(torch.as_tensor(tab[k]) for k in ("mu", "dense", "m", "cdf", "a0")),
                           torch.tensor(tab["eta"], dtype=torch.float32))


TABLES = {
    "lambertian": lambda: fb.synth_lambertian_table(0.5, 16),
    "glossy": lambda: fb.make_fourier_table(ms.glossy_fourier_table(n_mu=12)),
}


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(TABLES))
def case(request):
    tab = TABLES[request.param]()
    rng = np.random.default_rng(7)
    return request.param, tab, device_table(tab), jfb.to_device(tab), unit(rng, N), \
        unit(rng, N), rng.uniform(size=(N, 2)).astype(np.float32)


def test_eval_matches_jax(case):
    _, _, ft, jft, wo, wi, _ = case
    on = torch.ones(N, dtype=torch.bool)
    f, pdf = fk.fourier_eval(ft, torch.as_tensor(wo), torch.as_tensor(wi), on)
    jf = jfb.fourier_f(jft, jnp.asarray(wo), jnp.asarray(wi))
    jp = jfb.fourier_pdf(jft, jnp.asarray(wo), jnp.asarray(wi))
    assert float(f.max()) > 0.05 and float((pdf > 0).float().mean()) > 0.3
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)
    # lanes off `on` are zero
    half = torch.as_tensor(np.arange(N) % 2 == 0)
    f2, pdf2 = fb.fourier_eval_plain(ft, torch.as_tensor(wo), torch.as_tensor(wi), half)
    assert torch.equal(f2[half], f[half]) and not f2[~half].any() and not pdf2[~half].any()


def test_sample_matches_jax(case):
    _, _, ft, jft, wo, _, u2 = case
    on = torch.ones(N, dtype=torch.bool)
    wi = fk.fourier_sample(ft, torch.as_tensor(wo), torch.as_tensor(u2), on)
    jwi = np.asarray(jfb.fourier_sample(jft, jnp.asarray(wo), jnp.asarray(u2))[0])
    wide = np.isclose(wi.numpy(), jwi, rtol=2e-3, atol=1e-5).all(1)
    tight = np.isclose(wi.numpy(), jwi, rtol=1e-5, atol=1e-6).all(1)
    assert wide.mean() >= 0.99 and tight.mean() >= 0.95, (wide.mean(), tight.mean())
    assert torch.allclose(wi.norm(dim=1), torch.ones(N), atol=1e-5)
    # f and pdf at each lane's own wi, as bsdf_sample takes them
    f, pdf = fk.fourier_eval(ft, torch.as_tensor(wo), wi, on)
    np.testing.assert_allclose(f.numpy(), np.asarray(jfb.fourier_f(jft, jnp.asarray(wo),
                                                                   jnp.asarray(wi.numpy()))),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jfb.fourier_pdf(jft, jnp.asarray(wo),
                                                                       jnp.asarray(wi.numpy()))),
                               rtol=1e-4, atol=1e-6)
    # lanes off `on` are zero
    half = torch.as_tensor(np.arange(N) % 2 == 0)
    wi2 = fb.fourier_sample_plain(ft, torch.as_tensor(wo), torch.as_tensor(u2), half)
    assert torch.equal(wi2[half], wi[half]) and not wi2[~half].any()


def _scatfun(path, tab):
    """tab (glossy_fourier_table's dict) as a SCATFUN v1 file
    (reflection.rs:80-187): header, flags, sizes, eta, 4 unused ints, mu,
    cdf, (offset, order) per cell, the coefficients."""
    n_mu = tab["mu"].shape[0]
    with open(path, "wb") as f:
        f.write(b"SCATFUN\x01")
        f.write(struct.pack("<9i", 1, n_mu, tab["a"].shape[0], tab["m_max"], 3, 1, 0, 0, 0))
        f.write(struct.pack("<f", tab["eta"]))
        f.write(struct.pack("<4i", 0, 0, 0, 0))
        f.write(tab["mu"].astype("<f4").tobytes())
        f.write(tab["cdf"].astype("<f4").tobytes())
        f.write(np.stack([tab["a_offset"], tab["m"]], 1).astype("<i4").tobytes())
        f.write(tab["a"].astype("<f4").tobytes())


def test_scatfun_file_read_by_both(tmp_path):
    tab = ms.glossy_fourier_table(n_mu=12)
    path = tmp_path / "glossy.bsdf"
    _scatfun(path, tab)
    got, want = fb.read_bsdf_file(path), jfb.read_bsdf_file(path)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["a"], tab["a"])
    dense, jdense = fb.make_fourier_table(got), jfb.make_fourier_table(want)
    for k in dense:
        np.testing.assert_array_equal(np.asarray(dense[k]), np.asarray(jdense[k]), err_msg=k)
    bad = tmp_path / "bad.bsdf"
    bad.write_bytes(b"NOTSCAT\x01" + bytes(64))
    with pytest.raises(ValueError, match="SCATFUN"):
        fb.read_bsdf_file(bad)


def test_glossy_table_reproduces_its_brdf():
    """At node pairs (mu_i, mu_o) of a reflection, each cell's series is
    the BRDF times |mu_i| cut at its order: f within the cut orders' sum
    (divided by |mu_i|) and 1e-4 of f."""
    n_mu = 16
    raw = ms.glossy_fourier_table(n_mu=n_mu)
    ft = device_table(fb.make_fourier_table(raw))
    mu = raw["mu"].astype(np.float64)
    rng = np.random.default_rng(3)
    oi = [(o, i) for o in range(n_mu) for i in range(n_mu)
          if mu[o] * mu[i] < 0 and 0.05 < abs(mu[i]) < 0.999 and 0.05 < abs(mu[o]) < 0.999]
    assert len(oi) > 50
    o_idx, i_idx = np.array(oi).T
    phi = rng.uniform(0, np.pi, len(oi))
    mu_o, mu_i = mu[o_idx], mu[i_idx]
    # wo at azimuth 0; -wi at azimuth phi
    so, si = np.sqrt(1 - mu_o ** 2), np.sqrt(1 - mu_i ** 2)
    wo = np.stack([so, np.zeros_like(so), mu_o], -1).astype(np.float32)
    wi = -np.stack([si * np.cos(phi), si * np.sin(phi), mu_i], -1).astype(np.float32)
    f, _ = fb.fourier_eval_plain(ft, torch.as_tensor(wo), torch.as_tensor(wi),
                                 torch.ones(len(oi), dtype=torch.bool))
    want = ms.glossy_brdf(mu_i, mu_o, np.cos(phi))
    # the orders the table cuts: the series to 4 M_CAP orders, past each cell's m
    g = ms.glossy_brdf(mu_i[:, None], mu_o[:, None], np.cos(np.linspace(0, np.pi, 4097)))
    series = np.abs(np.fft.rfft(np.concatenate([g, g[:, -2:0:-1]], 1), axis=1).real)[:, :256]
    series = series / 8192 * 2 * np.abs(mu_i)[:, None, None]
    m = raw["m"][o_idx * n_mu + i_idx]
    # G comes from Y, R and B (1.398 Y - 0.297 R - 0.101 B): twice the
    # channels' largest cut bounds it
    cut = 2 * np.array([series[k, m[k]:].sum(0).max() for k in range(len(oi))]) / np.abs(mu_i)
    err = np.abs(f.numpy() - want)
    assert (err <= cut[:, None] + 1e-4 * want + 1e-5).all(), (err - cut[:, None]).max()
    assert np.median(want[:, 1]) > 0.05


def test_sample_pdf_consistency():
    """The Lambertian table's albedo by its own sampling (f |cos| / pdf)
    within 2% of rho; the directions drawn follow F1's pdf: the mean of
    cos^2 / pdf estimates the hemisphere's integral of cos^2, 2 pi / 3,
    within 2% (its standard error at 4,096 samples is ~0.6%)."""
    n = 4096
    ft = device_table(fb.synth_lambertian_table(0.5, 32))
    rng = np.random.default_rng(9)
    wo = torch.as_tensor(np.tile(np.array([[0.3, 0.2, 0.932737905]], np.float32), (n, 1)))
    on = torch.ones(n, dtype=torch.bool)
    wi = fb.fourier_sample_plain(ft, wo, torch.as_tensor(rng.uniform(size=(n, 2)),
                                                         dtype=torch.float32), on)
    f1, pdf1 = fb.fourier_eval_plain(ft, wo, wi, on)
    ok = pdf1 > 0
    assert float(ok.float().mean()) > 0.99
    albedo = (f1[:, 1] * wi[:, 2].abs() / torch.clamp(pdf1, min=1e-12))[ok].mean()
    assert abs(float(albedo) - 0.5) < 0.01, float(albedo)
    cos2 = (wi[:, 2] ** 2 / torch.clamp(pdf1, min=1e-12))[ok].sum() / n
    assert abs(float(cos2) / (2 * np.pi / 3) - 1) < 0.02, float(cos2)
