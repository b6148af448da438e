"""The Fourier BSDF: tabulated BSDFs of SCATFUN ``.bsdf`` files, the host
side and the plain versions of F1 and F2.

The port of the JAX package's ``ops/fourier_bsdf.py`` (reference
src/core/reflection.rs:64-130 FourierBSDFTable::read, FourierBSDF f /
sample_f / pdf :1480-1750, and interpolation.rs's fourier and
sample_fourier):

- host side: ``read_bsdf_file`` parses a SCATFUN v1 file,
  ``make_fourier_table`` repacks its ragged per-cell coefficient lists into
  dense rows of M_CAP orders a channel, ``synth_lambertian_table`` makes
  the table of a Lambertian reflector.  A scene carries one table, its
  ``fou_*`` fields (scene/arrays.py); ``table_of`` gives them as a
  FourierTable.
- ``fourier_eval_plain``: FourierBSDF::f and ::pdf (F1's plain version),
  the 16 spline-weighted cells accumulated tap by tap and the cosine
  series summed order by order as the JAX scan does.
- ``fourier_sample_plain``: FourierBSDF::sample_f (F2's plain version): the
  spline-interpolated row of a0 and the cdf at mu_o, the inversion in mu by
  12 bracketed Newton steps, the coefficients at (mu_i, mu_o) and 20
  bracketed Newton steps in phi over the 63-term sine/cosine recurrence,
  to the direction wi: the JAX bsdf_sample reads only wi, and f and pdf at
  wi are F1's.

The plain versions compute only the lanes of ``on`` (zeros elsewhere, as
the JAX ``where`` gives them) and take them CHUNK at a time, so the (N,
3 M_CAP) coefficient block stays bounded at millions of lanes.  The
reference's double-precision recurrences run in f32, as in the JAX
package.  ``ops/fourier_kernel.py`` holds the kernels' wrappers.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

M_CAP = 64  # the azimuthal orders a channel keeps (the JAX package's M_CAP)
CHUNK = 1 << 18  # lanes the plain versions take at once: a 192 MB coefficient block
NEWTON_MU_STEPS = 12
NEWTON_PHI_STEPS = 20
PI32 = float(np.float32(np.pi))  # pi as float32, as the JAX constants round to


class FourierTable(NamedTuple):
    """A scene's table on the device."""

    mu: torch.Tensor  # (MU,) the nodes in cos theta
    dense: torch.Tensor  # (MU*MU, 3*M_CAP) each cell's coefficients, channel-major
    m: torch.Tensor  # (MU*MU,) int32 each cell's order
    cdf: torch.Tensor  # (MU, MU) the luminance cdf along mu_i of each mu_o row
    a0: torch.Tensor  # (MU, MU) the first luminance coefficient of each cell
    eta: torch.Tensor  # () f32 the relative index across the layer


def table_of(scene) -> FourierTable:
    """The scene's Fourier table, or None without one."""
    if not scene.has_fourier:
        return None
    return FourierTable(scene.fou_mu, scene.fou_dense, scene.fou_m, scene.fou_cdf,
                        scene.fou_a0, scene.fou_eta)


# ---- host side ----

def read_bsdf_file(path) -> dict:
    """A SCATFUN v1 binary table (reflection.rs:80-187) -> dict of numpy
    arrays: mu, cdf, a_offset, m, a, eta, n_channels, m_max."""
    raw = open(path, "rb").read()
    if raw[:8] != b"SCATFUN\x01":
        raise ValueError(f"{path}: not a SCATFUN v1 file")
    flags, n_mu, n_coeffs, m_max, n_channels, n_bases = struct.unpack_from("<9i", raw, 8)[:6]
    (eta,) = struct.unpack_from("<f", raw, 8 + 36)
    if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
        raise ValueError(f"{path}: unsupported SCATFUN variant")
    off = 8 + 36 + 4 + 16
    mu = np.frombuffer(raw, "<f4", n_mu, off)
    off += 4 * n_mu
    cdf = np.frombuffer(raw, "<f4", n_mu * n_mu, off).reshape(n_mu, n_mu)
    off += 4 * n_mu * n_mu
    om = np.frombuffer(raw, "<i4", n_mu * n_mu * 2, off).reshape(-1, 2)
    off += 8 * n_mu * n_mu
    a = np.frombuffer(raw, "<f4", n_coeffs, off)
    return dict(mu=mu.copy(), cdf=cdf.copy(), a_offset=om[:, 0].copy(), m=om[:, 1].copy(),
                a=a.copy(), eta=float(eta), n_channels=int(n_channels), m_max=int(m_max))


def make_fourier_table(tab: dict, m_cap: int = M_CAP) -> dict:
    """A read_bsdf_file dict repacked into dense numpy arrays: mu, dense
    (cells, C m_cap), m (orders cut at m_cap), cdf, a0 (MU, MU), eta,
    n_channels."""
    n_mu = tab["mu"].shape[0]
    C = tab["n_channels"]
    cells = n_mu * n_mu
    dense = np.zeros((cells, C * m_cap), np.float32)
    a0 = np.zeros(cells, np.float32)
    for i in range(cells):
        m, o = int(tab["m"][i]), int(tab["a_offset"][i])
        mm = min(m, m_cap)
        if m > 0:
            a0[i] = tab["a"][o]
            for c in range(C):
                dense[i, c * m_cap:c * m_cap + mm] = tab["a"][o + c * m:o + c * m + mm]
    return dict(mu=tab["mu"].astype(np.float32), dense=dense,
                m=np.minimum(tab["m"], m_cap).astype(np.int32), cdf=tab["cdf"].astype(np.float32),
                a0=a0.reshape(n_mu, n_mu), eta=np.float32(tab["eta"]), n_channels=np.int32(C))


def synth_lambertian_table(rho=0.5, n_mu=16, m_cap: int = M_CAP) -> dict:
    """The dense table of a Lambertian reflector of albedo rho.  The series
    stores f |mu_i| (eval divides by |mu_i|); reflection lies where mu_i
    mu_o < 0 (incident directions negated); the cdf rows integrate a0 over
    mu_i (Catmull-Rom quadrature), the 2 pi of the azimuth applied in pdf
    (reflection.rs:1770-1782)."""
    from .bssrdf import integrate_catmull_rom

    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    dense = np.zeros((n_mu * n_mu, 3 * m_cap), np.float32)
    m = np.zeros(n_mu * n_mu, np.int32)
    a0 = np.zeros((n_mu, n_mu), np.float32)
    for o in range(n_mu):
        for i in range(n_mu):
            if mu[i] * mu[o] < 0.0:
                val = rho / np.pi * abs(mu[i])
                idx = o * n_mu + i
                dense[idx, [0, m_cap, 2 * m_cap]] = val
                m[idx] = 1
                a0[o, i] = val
    cdf, _total = integrate_catmull_rom(mu.astype(np.float64), a0)
    return dict(mu=mu, dense=dense, m=m, cdf=cdf.astype(np.float32), a0=a0,
                eta=np.float32(1.0), n_channels=np.int32(3))


# ---- the plain versions ----

def _cr_weights(nodes, x):
    """Catmull-Rom weights of x on the sorted nodes (the JAX
    _cr_weights_dyn): (valid, first tap idx - 1, (w0, w1, w2, w3)); the
    interval is the count of nodes <= x (searchsorted, right side)."""
    K = nodes.shape[0]
    valid = (x >= nodes[0]) & (x <= nodes[-1])
    cnt = torch.searchsorted(nodes, x.contiguous(), right=True)
    idx = torch.clamp(cnt - 1, 0, K - 2)
    x0, x1 = nodes[idx], nodes[idx + 1]
    t = (x - x0) / torch.clamp(x1 - x0, min=1e-20)
    t2 = t * t
    t3 = t2 * t
    w1b = 2 * t3 - 3 * t2 + 1
    w2b = -2 * t3 + 3 * t2
    xm1 = nodes[torch.clamp(idx - 1, min=0)]
    xp2 = nodes[torch.clamp(idx + 2, max=K - 1)]
    w0_i = (t3 - 2 * t2 + t) * (x1 - x0) / torch.clamp(x1 - xm1, min=1e-20)
    w3_i = (t3 - t2) * (x1 - x0) / torch.clamp(xp2 - x0, min=1e-20)
    at_lo, at_hi = idx == 0, idx + 2 >= K
    w0b = t3 - 2 * t2 + t
    w3b = t3 - t2
    w0 = torch.where(at_lo, 0.0, -w0_i)
    w1 = w1b - torch.where(at_lo, w0b, 0.0) - torch.where(at_hi, w3b, w3_i)
    w2 = w2b + torch.where(at_lo, w0b, w0_i) + torch.where(at_hi, w3b, 0.0)
    w3 = torch.where(at_hi, 0.0, w3_i)
    return valid, idx - 1, (w0, w1, w2, w3)


def _accumulate(ft: FourierTable, mu_i, mu_o):
    """The 16 cells' coefficients at (mu_i, mu_o), spline-weighted and summed
    tap by tap, o-tap major (reflection.rs:1528-1546): (valid, ak (N, 3
    M_CAP))."""
    MU = ft.mu.shape[0]
    ok_i, off_i, wi4 = _cr_weights(ft.mu, mu_i)
    ok_o, off_o, wo4 = _cr_weights(ft.mu, mu_o)
    ak = torch.zeros((mu_i.shape[0], ft.dense.shape[1]), device=mu_i.device)
    for b in range(4):
        row_o = torch.clamp(off_o + b, 0, MU - 1)
        for a in range(4):
            row_i = torch.clamp(off_i + a, 0, MU - 1)
            w = wi4[a] * wo4[b]
            ak = ak + w[:, None] * ft.dense[row_o * MU + row_i]
    return ok_i & ok_o, ak


def _fourier_sum(ak_ch, cos_phi):
    """sum_k a_k cos(k phi) by the double-angle recurrence, order by order
    (interpolation.rs:209-222)."""
    cos_km1, cos_k, val = cos_phi, torch.ones_like(cos_phi), torch.zeros_like(cos_phi)
    for k in range(ak_ch.shape[1]):
        val = val + ak_ch[:, k] * cos_k
        cos_km1, cos_k = cos_k, 2.0 * cos_phi * cos_k - cos_km1
    return val


def _cos_d_phi(wa, wb):
    """The cosine of the azimuth between wa and wb (geometry cos_d_phi), 1
    where either lies on the pole."""
    waxy = wa[:, 0] * wa[:, 0] + wa[:, 1] * wa[:, 1]
    wbxy = wb[:, 0] * wb[:, 0] + wb[:, 1] * wb[:, 1]
    num = wa[:, 0] * wb[:, 0] + wa[:, 1] * wb[:, 1]
    den = torch.sqrt(torch.clamp(waxy * wbxy, min=1e-20))
    return torch.where((waxy > 0) & (wbxy > 0), torch.clamp(num / den, -1.0, 1.0), 1.0)


def _eval(ft: FourierTable, wo, wi):
    """(f (N, 3), pdf (N,)) of every lane of wo, wi: the JAX fourier_f and
    fourier_pdf."""
    MU = ft.mu.shape[0]
    mu_i, mu_o = -wi[:, 2], wo[:, 2]
    cos_phi = _cos_d_phi(-wi, wo)
    ok, ak = _accumulate(ft, mu_i, mu_o)
    y = torch.clamp(_fourier_sum(ak[:, 0:M_CAP], cos_phi), min=0.0)
    r = _fourier_sum(ak[:, M_CAP:2 * M_CAP], cos_phi)
    bl = _fourier_sum(ak[:, 2 * M_CAP:3 * M_CAP], cos_phi)
    g = 1.39829 * y - 0.100913 * bl - 0.297375 * r
    scale = torch.where(mu_i != 0.0, 1.0 / torch.clamp(mu_i.abs(), min=1e-20), 0.0)
    # radiance transport's eta^2 on transmission
    eta = torch.where(mu_i > 0.0, 1.0 / ft.eta, ft.eta)
    scale = scale * torch.where(mu_i * mu_o > 0.0, eta * eta, 1.0)
    rgb = torch.stack([r, g, bl], -1) * scale[:, None]
    f = torch.where(ok[:, None], torch.clamp(rgb, min=0.0), 0.0)
    _, off_o, wo4 = _cr_weights(ft.mu, mu_o)
    rho = torch.zeros_like(mu_o)
    for b in range(4):
        row = torch.clamp(off_o + b, 0, MU - 1)
        rho = rho + wo4[b] * ft.cdf[row, MU - 1] * (2.0 * PI32)
    pdf = torch.where(ok & (rho > 0.0), y / torch.clamp(rho, min=1e-20), 0.0)
    return f, pdf


def _lanes(on, n_out, fn, *planes):
    """fn over the lanes of on, CHUNK at a time; zeros elsewhere.  n_out:
    the columns of each of fn's outputs (0 for an (N,) output)."""
    n = on.shape[0]
    outs = [torch.zeros((n, c) if c else (n,), device=on.device) for c in n_out]
    idx = torch.nonzero(on).flatten()
    for s in range(0, idx.shape[0], CHUNK):
        ids = idx[s:s + CHUNK]
        for out, val in zip(outs, fn(*(p[ids] for p in planes))):
            out[ids] = val
    return outs


def fourier_eval_plain(ft: FourierTable, wo, wi, on):
    """F1's plain version: (f (N, 3), pdf (N,)), the JAX fourier_f and
    fourier_pdf on the lanes of on (N,) bool, zeros elsewhere."""
    return tuple(_lanes(on, (3, 0), lambda a, b: _eval(ft, a, b), wo, wi))


def _row_interp(ft: FourierTable, table2d, off_o, wo4):
    MU = ft.mu.shape[0]
    out = None
    for b in range(4):
        row = torch.clamp(off_o + b, 0, MU - 1)
        v = wo4[b][:, None] * table2d[row]
        out = v if out is None else out + v
    return out


def _sample(ft: FourierTable, wo, u2):
    """The direction wi (N, 3) that the JAX fourier_sample draws on every
    lane (its pdf and f at wi are _eval's)."""
    MU = ft.mu.shape[0]
    mu_o = wo[:, 2]
    _, off_o, wo4 = _cr_weights(ft.mu, mu_o)
    vals = _row_interp(ft, ft.a0, off_o, wo4)
    cdfs = _row_interp(ft, ft.cdf, off_o, wo4)
    # invert the interpolated cdf along mu_i (sample_catmull_rom_2d); the
    # rows need not be monotone, so the interval is the count of entries <= u
    maximum = cdfs[:, -1]
    uu = u2[:, 1] * maximum
    cnt = (cdfs <= uu[:, None]).sum(-1)
    idx = torch.clamp(cnt - 1, 0, MU - 2)
    take = lambda a, i: a.gather(1, torch.clamp(i, 0, MU - 1)[:, None])[:, 0]
    f0, f1 = take(vals, idx), take(vals, idx + 1)
    x0, x1 = ft.mu[idx], ft.mu[idx + 1]
    width = x1 - x0
    u_loc = (uu - take(cdfs, idx)) / torch.clamp(width, min=1e-20)
    fm1, f2 = take(vals, idx - 1), take(vals, idx + 2)
    xm1 = ft.mu[torch.clamp(idx - 1, min=0)]
    xp2 = ft.mu[torch.clamp(idx + 2, max=MU - 1)]
    d0 = torch.where(idx > 0, width * (f1 - fm1) / torch.clamp(x1 - xm1, min=1e-20), f1 - f0)
    d1 = torch.where(idx + 2 < MU, width * (f2 - f0) / torch.clamp(xp2 - x0, min=1e-20), f1 - f0)
    sloped = (f0 - f1).abs() > 1e-20
    t = torch.where(sloped, (f0 - torch.sqrt(torch.clamp(f0 * f0 + 2.0 * u_loc * (f1 - f0),
                                                         min=0.0)))
                    / torch.where(sloped, f0 - f1, 1.0), u_loc / torch.clamp(f0, min=1e-20))
    a_b, b_b, fhat = torch.zeros_like(t), torch.ones_like(t), f0
    third = float(np.float32(1.0 / 3.0))
    for _ in range(NEWTON_MU_STEPS):
        t = torch.where((t >= a_b) & (t <= b_b), t, 0.5 * (a_b + b_b))
        f_hat = t * (f0 + t * (0.5 * d0 + t * (third * (-2.0 * d0 - d1) + f1 - f0
                                                + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2.0 * d0 - d1 + 3.0 * (f1 - f0)
                                   + t * (d0 + d1 + 2.0 * (f0 - f1))))
        below = f_hat < u_loc
        a_b = torch.where(below, t, a_b)
        b_b = torch.where(below, b_b, t)
        t = t - (f_hat - u_loc) / torch.where(fhat.abs() < 1e-12, 1e-12, fhat)
    mu_i = x0 + width * torch.clamp(t, 0.0, 1.0)

    # the coefficients at (mu_i, mu_o) and the inversion in phi
    _, ak = _accumulate(ft, mu_i, mu_o)
    ak_y = ak[:, 0:M_CAP]
    u = u2[:, 0]
    flip = u >= 0.5
    u_side = torch.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)
    a0c = ak_y[:, 0]
    recip = 1.0 / torch.arange(1, M_CAP, dtype=torch.float32, device=wo.device)
    rk = [ak_y[:, k] * recip[k - 1] for k in range(1, M_CAP)]

    def cf_and_deriv(phi):
        """F(phi) = a0 phi + sum a_k / k sin(k phi), f(phi) = sum a_k cos(k phi)."""
        cos_phi = torch.cos(phi)
        sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
        sin_prev, sin_cur, cos_prev, cos_cur = -sin_phi, torch.zeros_like(phi), cos_phi, \
            torch.ones_like(phi)
        cf, fd = a0c * phi, a0c + torch.zeros_like(phi)
        for k in range(1, M_CAP):
            sin_next = 2.0 * cos_phi * sin_cur - sin_prev
            cos_next = 2.0 * cos_phi * cos_cur - cos_prev
            cf = cf + rk[k - 1] * sin_next
            fd = fd + ak_y[:, k] * cos_next
            sin_prev, sin_cur, cos_prev, cos_cur = sin_cur, sin_next, cos_cur, cos_next
        return cf, fd

    a_ph, b_ph = torch.zeros_like(u), torch.full_like(u, PI32)
    phi = torch.full_like(u, float(np.float32(0.5 * np.pi)))
    for _ in range(NEWTON_PHI_STEPS):
        cf, f_der = cf_and_deriv(phi)
        cf = cf - u_side * a0c * PI32
        pos = cf > 0.0
        b_ph = torch.where(pos, phi, b_ph)
        a_ph = torch.where(pos, a_ph, phi)
        phi_n = phi - cf / torch.where(f_der.abs() < 1e-12, 1e-12, f_der)
        phi = torch.where((phi_n > a_ph) & (phi_n < b_ph), phi_n, 0.5 * (a_ph + b_ph))
    phi = torch.where(flip, float(np.float32(2.0 * np.pi)) - phi, phi)

    # the scattered direction (reflection.rs:1662-1692)
    sin2_i = torch.clamp(1.0 - mu_i * mu_i, min=0.0)
    sin2_o = 1.0 - mu_o * mu_o
    norm = torch.sqrt(sin2_i / torch.clamp(sin2_o, min=1e-20))
    norm = torch.where(sin2_o <= 0.0, 0.0, norm)
    sp, cp = torch.sin(phi), torch.cos(phi)
    wi = -torch.stack([norm * (cp * wo[:, 0] - sp * wo[:, 1]),
                       norm * (sp * wo[:, 0] + cp * wo[:, 1]), mu_i], -1)
    length = torch.sqrt(wi[:, 0] * wi[:, 0] + wi[:, 1] * wi[:, 1] + wi[:, 2] * wi[:, 2])
    return wi / torch.clamp(length, min=1e-20)[:, None]


def fourier_sample_plain(ft: FourierTable, wo, u2, on):
    """F2's plain version: wi (N, 3), the direction the JAX fourier_sample
    draws on the lanes of on (N,) bool, zeros elsewhere."""
    return _lanes(on, (3,), lambda a, b: (_sample(ft, a, b),), wo, u2)[0]
