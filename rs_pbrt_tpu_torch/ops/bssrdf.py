"""Tabulated BSSRDF (subsurface scattering): photon-beam-diffusion tables.

The port of the JAX package's ``ops/bssrdf.py`` (reference
src/core/bssrdf.rs and the spline functions of src/core/interpolation.rs).
Its departures from the reference are the JAX package's:

1. rho = sigma_s / sigma_t is a constant of a material's channel, so the
   (rho, radius) table is folded along rho once, on the host, when the
   scene is built (``make_material_tables``): each subsurface material
   carries three per-channel 64-sample radius profiles and their CDFs.
2. sample_catmull_rom_2d's unbounded Newton-bisection loop
   (interpolation.rs:120-172) is a fixed 12-step bisection-Newton
   (``sample_sr_channel``).

The host half (numpy) is the port's own copy of the JAX table code.  The
render-time half takes the scene's folded tables whole, (R, K) rows, with
a row index per lane, instead of a per-lane copy of the row: the values
read are the same, and a batch of 2^22 lanes does not hold 2^22 copies of
a 64-sample row.  The interval of x in the fixed radius grid is found by
``torch.searchsorted`` (the JAX package counts comparisons: the same index,
NaN taking the first interval as it does there); the interval of u in a
lane's CDF is found by counting, as there, so that a CDF that is not
monotone gives the same index.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .bsdf import fr_dielectric

N_RHO = 100
N_RADIUS = 64
INV_4_PI = 1.0 / (4.0 * np.pi)
NEWTON_STEPS = 12


# ---------------------------------------------------------------------------
# host-side table construction (numpy)
# ---------------------------------------------------------------------------


def fresnel_moment1(eta):
    e2, e3 = eta * eta, eta**3
    e4, e5 = eta**4, eta**5
    if eta < 1.0:
        return 0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3 + 2.49277 * e4 - 0.68441 * e5
    return -4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3 - 1.27198 * e4 + 0.12746 * e5


def fresnel_moment2(eta):
    e2, e3, e4, e5 = eta * eta, eta**3, eta**4, eta**5
    if eta < 1.0:
        return 0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3 + 0.07883 * e4 + 0.04860 * e5
    r = 1.0 / eta
    return (
        -547.033 + 45.3087 * r**3 - 218.725 * r**2 + 458.843 * r
        + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4 + 0.63942 * e5
    )


def _fr_dielectric_np(cos_i, eta_i, eta_t):
    cos_i = np.clip(cos_i, -1.0, 1.0)
    swap = cos_i <= 0.0
    ei = np.where(swap, eta_t, eta_i)
    et = np.where(swap, eta_i, eta_t)
    ci = np.abs(cos_i)
    sin_t = ei / et * np.sqrt(np.maximum(0.0, 1.0 - ci * ci))
    tir = sin_t >= 1.0
    ct = np.sqrt(np.maximum(0.0, 1.0 - sin_t * sin_t))
    r_par = (et * ci - ei * ct) / np.maximum(et * ci + ei * ct, 1e-12)
    r_perp = (ei * ci - et * ct) / np.maximum(ei * ci + et * ct, 1e-12)
    return np.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))


def _phase_hg_np(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4_PI * (1.0 - g * g) / np.maximum(denom * np.sqrt(np.maximum(denom, 1e-12)), 1e-12)


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r):
    """Multiple-scattering dipole term (bssrdf.rs:569-617), vectorized in r."""
    n = 100
    sp_s = sigma_s * (1.0 - g)
    sp_t = sigma_a + sp_s
    rhop = sp_s / sp_t
    d_g = (2.0 * sigma_a + sp_s) / (3.0 * sp_t * sp_t)
    sigma_tr = np.sqrt(sigma_a / d_g)
    fm1, fm2 = fresnel_moment1(eta), fresnel_moment2(eta)
    ze = -2.0 * d_g * (1.0 + 3.0 * fm2) / (1.0 - 2.0 * fm1)
    c_phi = 0.25 * (1.0 - 2.0 * fm1)
    c_e = 0.5 * (1.0 - 3.0 * fm2)
    i = np.arange(n)[:, None]
    zr = -np.log(1.0 - (i + 0.5) / n) / sp_t
    zv = -zr + 2.0 * ze
    r = np.asarray(r)[None, :]
    dr = np.sqrt(r * r + zr * zr)
    dv = np.sqrt(r * r + zv * zv)
    phi_d = INV_4_PI / d_g * (np.exp(-sigma_tr * dr) / dr - np.exp(-sigma_tr * dv) / dv)
    ed_n = INV_4_PI * (
        zr * (1.0 + sigma_tr * dr) * np.exp(-sigma_tr * dr) / dr**3
        - zv * (1.0 + sigma_tr * dv) * np.exp(-sigma_tr * dv) / dv**3
    )
    e = phi_d * c_phi + ed_n * c_e
    kappa = 1.0 - np.exp(-2.0 * sp_t * (dr + zr))
    return (kappa * rhop * rhop * e).mean(0)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r):
    """Single-scattering term (bssrdf.rs:619-640), vectorized in r."""
    n = 100
    sigma_t = sigma_a + sigma_s
    rho = sigma_s / sigma_t
    r = np.asarray(r)[None, :]
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = np.arange(n)[:, None]
    ti = t_crit - np.log(1.0 - (i + 0.5) / n) / sigma_t
    d = np.sqrt(r * r + ti * ti)
    cto = ti / np.maximum(d, 1e-12)
    ess = (
        rho * np.exp(-sigma_t * (d + t_crit)) / np.maximum(d * d, 1e-12)
        * _phase_hg_np(cto, g)
        * (1.0 - _fr_dielectric_np(-cto, 1.0, eta))
        * np.abs(cto)
    )
    return ess.mean(0)


def radius_grid(n=N_RADIUS):
    """bssrdf.rs:644-649: 0, 2.5e-3, then each 1.2 times the last."""
    r = np.zeros(n, np.float64)
    r[1] = 2.5e-3
    for i in range(2, n):
        r[i] = r[i - 1] * 1.2
    return r


def rho_grid(n=N_RHO):
    i = np.arange(n, dtype=np.float64)
    return (1.0 - np.exp(-8.0 * i / (n - 1))) / (1.0 - np.exp(-8.0))


def _cr_derivs_np(x, f):
    """Catmull-Rom derivatives per segment from finite differences at the
    ends (interpolation.rs:190-200).  x: (K,), f: (..., K)."""
    K = x.shape[0]
    width = x[1:] - x[:-1]
    d0 = np.empty(f.shape[:-1] + (K - 1,))
    d1 = np.empty_like(d0)
    d0[..., 0] = f[..., 1] - f[..., 0]
    d0[..., 1:] = width[1:] * (f[..., 2:] - f[..., :-2]) / (x[2:] - x[:-2])
    d1[..., :-1] = d0[..., 1:]
    d1[..., -1] = f[..., -1] - f[..., -2]
    return d0, d1, width


def integrate_catmull_rom(x, f):
    """(interpolation.rs:174-206): (cdf of f's shape, total)."""
    d0, d1, width = _cr_derivs_np(np.asarray(x, np.float64), np.asarray(f, np.float64))
    seg = ((d0 - d1) / 12.0 + (f[..., :-1] + f[..., 1:]) * 0.5) * width
    cdf = np.zeros_like(f)
    cdf[..., 1:] = np.cumsum(seg, axis=-1)
    return cdf, cdf[..., -1]


def compute_beam_diffusion_table(g, eta, n_rho=N_RHO, n_radius=N_RADIUS):
    """BssrdfTable (bssrdf.rs:642-682): profile[rho, radius], rho_eff, cdf."""
    rs = radius_grid(n_radius)
    rhos = rho_grid(n_rho)
    profile = np.zeros((n_rho, n_radius))
    for i, rho in enumerate(rhos):
        profile[i] = (
            2.0 * np.pi * rs
            * (beam_diffusion_ss(rho, 1.0 - rho, g, eta, rs)
               + beam_diffusion_ms(rho, 1.0 - rho, g, eta, rs))
        )
    cdf, rho_eff = integrate_catmull_rom(rs, profile)
    return dict(rho_samples=rhos, radius_samples=rs, profile=profile,
                profile_cdf=cdf, rho_eff=rho_eff)


def catmull_rom_weights_np(nodes, x):
    """Scalar spline weights (interpolation.rs:15-62): (valid, offset,
    w[4])."""
    nodes = np.asarray(nodes)
    if not (nodes[0] <= x <= nodes[-1]):
        return False, 0, np.zeros(4)
    idx = int(np.searchsorted(nodes, x, side="right") - 1)
    idx = min(max(idx, 0), len(nodes) - 2)
    x0, x1 = nodes[idx], nodes[idx + 1]
    t = (x - x0) / (x1 - x0)
    t2, t3 = t * t, t**3
    w = np.zeros(4)
    w[1] = 2 * t3 - 3 * t2 + 1
    w[2] = -2 * t3 + 3 * t2
    if idx > 0:
        w0 = (t3 - 2 * t2 + t) * (x1 - x0) / (x1 - nodes[idx - 1])
        w[0] = -w0
        w[2] += w0
    else:
        w0 = t3 - 2 * t2 + t
        w[1] -= w0
        w[2] += w0
    if idx + 2 < len(nodes):
        w3 = (t3 - t2) * (x1 - x0) / (nodes[idx + 2] - x0)
        w[1] -= w3
        w[3] = w3
    else:
        w3 = t3 - t2
        w[1] -= w3
        w[2] += w3
    return True, idx - 1, w


def fold_rho(table, rho):
    """The table at a fixed albedo rho (the render-time rho weights of
    bssrdf.rs:305-330 are a material's constants): one channel's
    (profile (K,), cdf (K,), rho_eff)."""
    ok, off, w = catmull_rom_weights_np(table["rho_samples"], float(rho))
    K = table["radius_samples"].shape[0]
    if not ok:
        return np.zeros(K), np.zeros(K), 1.0
    prof = np.zeros(K)
    cdf = np.zeros(K)
    eff = 0.0
    for i in range(4):
        if w[i] == 0.0:
            continue
        row = min(max(off + i, 0), table["profile"].shape[0] - 1)
        prof += w[i] * table["profile"][row]
        cdf += w[i] * table["profile_cdf"][row]
        eff += w[i] * table["rho_eff"][row]
    return prof, cdf, max(eff, 1e-12)


def make_material_tables(sigma_a, sigma_s, g, eta):
    """A subsurface material's folded tables: dict of profile (3, K), cdf
    (3, K), rho_eff (3,), sigma_t (3,) and eta."""
    sigma_a = np.asarray(sigma_a, np.float64)
    sigma_s = np.asarray(sigma_s, np.float64)
    sigma_t = sigma_a + sigma_s
    rho = np.where(sigma_t > 0, sigma_s / np.maximum(sigma_t, 1e-12), 0.0)
    table = compute_beam_diffusion_table(g, eta)
    prof = np.zeros((3, N_RADIUS), np.float32)
    cdf = np.zeros((3, N_RADIUS), np.float32)
    eff = np.zeros(3, np.float32)
    for c in range(3):
        p, cd, e = fold_rho(table, rho[c])
        prof[c], cdf[c], eff[c] = p, cd, e
    return dict(profile=prof, cdf=cdf, rho_eff=eff,
                sigma_t=sigma_t.astype(np.float32), eta=np.float32(eta))


# ---------------------------------------------------------------------------
# render-time spline evaluation and sampling (torch)
# ---------------------------------------------------------------------------

RADIUS_NODES = radius_grid().astype(np.float32)


@lru_cache(maxsize=None)
def _nodes(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(RADIUS_NODES, device=device)


def _find_interval(nodes, x):
    """The segment of x in the fixed grid: the count of nodes <= x, less
    one, clamped to [0, K-2] (a NaN x counts none)."""
    idx = torch.searchsorted(nodes, x.contiguous(), right=True) - 1
    idx = torch.where(torch.isnan(x), 0, idx)
    return torch.clamp(idx, 0, nodes.shape[0] - 2)


def _cr_weights(x):
    """catmull_rom_weights over the fixed radius grid, per lane: (valid,
    idx, (w0, w1, w2, w3)); idx is the segment's start, the taps are
    idx-1 .. idx+2 (interpolation.rs:38-60's edge fixups as selects)."""
    nodes = _nodes(x.device)
    K = nodes.shape[0]
    valid = (x >= float(RADIUS_NODES[0])) & (x <= float(RADIUS_NODES[-1]))
    idx = _find_interval(nodes, x)
    x0 = nodes[idx]
    x1 = nodes[idx + 1]
    t = (x - x0) / torch.clamp(x1 - x0, min=1e-20)
    t2 = t * t
    t3 = t2 * t
    w1b = 2 * t3 - 3 * t2 + 1
    w2b = -2 * t3 + 3 * t2
    xm1 = nodes[torch.clamp(idx - 1, min=0)]
    xp2 = nodes[torch.clamp(idx + 2, max=K - 1)]
    w0_i = (t3 - 2 * t2 + t) * (x1 - x0) / torch.clamp(x1 - xm1, min=1e-20)
    w3_i = (t3 - t2) * (x1 - x0) / torch.clamp(xp2 - x0, min=1e-20)
    at_lo = idx == 0
    at_hi = idx + 2 >= K
    w0b = t3 - 2 * t2 + t
    w3b = t3 - t2
    w0 = torch.where(at_lo, 0.0, -w0_i)
    w1 = w1b - torch.where(at_lo, w0b, 0.0) - torch.where(at_hi, w3b, w3_i)
    w2 = w2b + torch.where(at_lo, w0b, w0_i) + torch.where(at_hi, w3b, 0.0)
    w3 = torch.where(at_hi, 0.0, w3_i)
    return valid, idx, (w0, w1, w2, w3)


def _taps(table, row, idx):
    """table (R, K) read at rows `row` (N,) and columns idx-1 .. idx+2,
    clamped to the row."""
    K = table.shape[-1]
    flat = table.reshape(-1)
    base = row * K
    return tuple(flat[base + torch.clamp(idx + j, 0, K - 1)] for j in (-1, 0, 1, 2))


def spline_eval(table, row, x):
    """Catmull-Rom interpolation of the rows `row` (N,) of table (R, K),
    on the fixed radius grid, at x (N,); 0 outside the grid."""
    valid, idx, (w0, w1, w2, w3) = _cr_weights(x)
    fm1, f0, f1, f2 = _taps(table, row, idx)
    out = w0 * fm1 + w1 * f0 + w2 * f1 + w3 * f2
    return torch.where(valid, out, 0.0)


def _sr_term(table, row, sigma_t_ch, r):
    r_opt = r * sigma_t_ch
    f = spline_eval(table, row, r_opt)
    f = torch.where(r_opt > 0.0, f / (2.0 * np.pi * torch.clamp(r_opt, min=1e-20)), f)
    return f * sigma_t_ch * sigma_t_ch


def sr_eval(profile, bid, sigma_t, r):
    """Sr(r) (bssrdf.rs:295-340) of every channel: profile (B, 3, K) the
    scene's folded profiles, bid (N,) each lane's material row, sigma_t
    (N, 3), r (N,) -> (N, 3)."""
    rows = profile.reshape(-1, profile.shape[-1])
    out = [_sr_term(rows, bid * 3 + c, sigma_t[:, c], r) for c in range(3)]
    return torch.clamp(torch.stack(out, -1), min=0.0)


def pdf_sr_channel(profile, row, rho_eff_ch, sigma_t_ch, r):
    """pdf_sr of one channel (bssrdf.rs:341-386): profile (R, K) rows, row
    (N,) each lane's row, rho_eff_ch, sigma_t_ch and r (N,)."""
    f = _sr_term(profile, row, sigma_t_ch, r)
    return torch.clamp(f / torch.clamp(rho_eff_ch, min=1e-12), min=0.0)


def sample_sr_channel(profile, cdf, row, sigma_t_ch, u):
    """Inverts one channel's radial CDF (sample_catmull_rom_2d,
    interpolation.rs:64-172) by a fixed 12-step bisection-Newton.
    profile, cdf (R, K) rows, row (N,) each lane's row, sigma_t_ch and u
    (N,).  Returns the world-space radius (-1 where sigma_t is 0, the
    reference's sentinel)."""
    nodes = _nodes(u.device)
    K = nodes.shape[0]
    cdf_rows = cdf[row]  # (N, K): the comparison count reads the whole row
    maximum = cdf_rows[:, -1]
    uu = u * maximum
    cnt = (cdf_rows <= uu[:, None]).sum(-1)
    idx = torch.clamp(cnt - 1, 0, K - 2)
    del cdf_rows
    flat_p, flat_c = profile.reshape(-1), cdf.reshape(-1)
    take = lambda flat, i: flat[row * K + torch.clamp(i, 0, K - 1)]
    f0 = take(flat_p, idx)
    f1 = take(flat_p, idx + 1)
    x0 = nodes[idx]
    x1 = nodes[idx + 1]
    width = x1 - x0
    uu = (uu - take(flat_c, idx)) / torch.clamp(width, min=1e-20)
    fm1 = take(flat_p, idx - 1)
    f2 = take(flat_p, idx + 2)
    xm1 = nodes[torch.clamp(idx - 1, min=0)]
    xp2 = nodes[torch.clamp(idx + 2, max=K - 1)]
    d0 = torch.where(idx > 0, width * (f1 - fm1) / torch.clamp(x1 - xm1, min=1e-20), f1 - f0)
    d1 = torch.where(idx + 2 < K, width * (f2 - f0) / torch.clamp(xp2 - x0, min=1e-20), f1 - f0)

    # initial guess: the linear interpolant's inverse (interpolation.rs:123-130)
    lin = (f0 - f1).abs() > 1e-20
    t = torch.where(
        lin,
        (f0 - torch.sqrt(torch.clamp(f0 * f0 + 2.0 * uu * (f1 - f0), min=0.0)))
        / torch.where(lin, f0 - f1, 1.0),
        uu / torch.clamp(f0, min=1e-20),
    )
    a = torch.zeros_like(t)
    b = torch.ones_like(t)
    for _ in range(NEWTON_STEPS):
        t = torch.where((t >= a) & (t <= b), t, 0.5 * (a + b))
        f_hat = t * (
            f0
            + t * (0.5 * d0
                   + t * ((1.0 / 3.0) * (-2.0 * d0 - d1) + f1 - f0
                          + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1))))
        )
        fhat = f0 + t * (
            d0 + t * (-2.0 * d0 - d1 + 3.0 * (f1 - f0) + t * (d0 + d1 + 2.0 * (f0 - f1)))
        )
        below = f_hat < uu
        a = torch.where(below, t, a)
        b = torch.where(below, b, t)
        # Newton; a vanishing derivative falls back to bisection through the
        # bracket test at the loop's top
        t = t - (f_hat - uu) / torch.where(fhat.abs() < 1e-12, 1e-12, fhat)
    r_opt = x0 + width * torch.clamp(t, 0.0, 1.0)
    r = r_opt / torch.clamp(sigma_t_ch, min=1e-20)
    return torch.where(sigma_t_ch > 0.0, r, -1.0)


def sw_factor(eta, cos_theta_w):
    """The directional term Sw (bssrdf.rs:96-101) per lane."""
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    fm1 = -4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3 - 1.27198 * e4 + 0.12746 * e5
    fm1 = torch.where(
        eta < 1.0,
        0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3 + 2.49277 * e4 - 0.68441 * e5,
        fm1,
    )
    c = 1.0 - 2.0 * fm1
    return (1.0 - fr_dielectric(cos_theta_w, torch.ones_like(eta), eta)) / (c * np.pi)
