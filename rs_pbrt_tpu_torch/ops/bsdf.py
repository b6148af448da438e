"""The BSDF of matte, mirror, glass, hair and subsurface materials as
batched tag-switched code.

The port of the JAX package's ``ops/bsdf.py`` for the lobes of the matte,
mirror, glass and hair materials, and the subsurface material's surface,
which has glass's lobes (reference src/core/reflection.rs, microfacet.rs,
materials/matte.rs, mirror.rs, glass.rs, hair.rs and subsurface.rs):
Lambert, Oren-Nayar (matte with sigma > 0), perfect specular reflection,
FresnelSpecular (smooth glass), TrowbridgeReitz microfacet reflection and
transmission (rough glass) and the Marschner/Chiang hair lobe
(hair.rs:178-790).  Every lane carries up to two lobe slots of the JAX
package's Bsdf; each lobe family is evaluated for all lanes and selected
by its tag.  Other materials and textured parameters raise
NotImplementedError (``check_supported``).

Convention: the shading-local frame has z = the shading normal and x the
surface's u tangent (a fibre's direction on curves); wo and wi are unit
vectors in it.  Reflection against transmission is decided on the
geometric normal by the caller (the ``reflect`` flag); the hair lobe
scatters over the whole sphere and ignores it.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from ..scene import arrays as sa
from ..utils import vecmath as vm
from .sampling import concentric_sample_disk, cosine_sample_hemisphere

INV_PI = float(vm.INV_PI)

# lobe tags, numbered as in the JAX package (the other 12 come with their
# materials)
LOBE_NONE = 0
LOBE_LAMBERT = 1
LOBE_ORENNAYAR = 2
LOBE_SPEC_REFL = 3
LOBE_FRESNEL_SPEC = 4  # FresnelSpecular: smooth glass's reflection or refraction
LOBE_MICROFACET_REFL = 5  # MicrofacetReflection with a dielectric Fresnel term
LOBE_HAIR = 10
LOBE_MICROFACET_TRANS = 13  # MicrofacetTransmission (reflection.rs:1211)
SPECULAR_LOBES = (LOBE_SPEC_REFL, LOBE_FRESNEL_SPEC)
PORTED_MATERIALS = ((1 << sa.MATTE) | (1 << sa.MIRROR) | (1 << sa.GLASS) | (1 << sa.HAIR)
                    | (1 << sa.SUBSURFACE))
PI = math.pi


def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return w[..., 2].abs()


def sin2_theta(w):
    return torch.clamp(1.0 - w[..., 2] * w[..., 2], min=0.0)


def cos_phi(w):
    s = torch.sqrt(torch.clamp(sin2_theta(w), min=1e-24))
    return torch.where(sin2_theta(w) == 0.0, 1.0, torch.clamp(w[..., 0] / s, -1, 1))


def sin_phi(w):
    s = torch.sqrt(torch.clamp(sin2_theta(w), min=1e-24))
    return torch.where(sin2_theta(w) == 0.0, 0.0, torch.clamp(w[..., 1] / s, -1, 1))


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def tan2_theta(w):
    return sin2_theta(w) / torch.clamp(cos2_theta(w), min=1e-20)


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def reflect_dir(wo, n):
    return -wo + 2.0 * vm.dot(wo, n)[..., None] * n


def refract_dir(wi, n, eta):
    """(ok, wt): wi refracted through the interface of normal n with the
    relative index eta (geometry.rs refract); ok False at total internal
    reflection."""
    cos_i = vm.dot(n, wi)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    return sin2_t < 1.0, eta[..., None] * -wi + (eta * cos_i - cos_t)[..., None] * n


def oren_nayar_ab(sigma_deg):
    """Oren-Nayar's A and B of sigma in degrees (reflection.rs OrenNayar::new)."""
    sigma = torch.deg2rad(sigma_deg)
    sigma2 = sigma * sigma
    return 1.0 - sigma2 / (2.0 * (sigma2 + 0.33)), 0.45 * sigma2 / (sigma2 + 0.09)


def oren_nayar_f(r, sigma_deg, wo, wi):
    """Oren-Nayar f (reflection.rs OrenNayar); r (N,3), sigma in degrees."""
    a, b = oren_nayar_ab(sigma_deg)
    sin_ti = torch.sqrt(torch.clamp(sin2_theta(wi), min=1e-24))
    sin_to = torch.sqrt(torch.clamp(sin2_theta(wo), min=1e-24))
    cos_diff = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo)
    max_cos = torch.where((sin_ti > 1e-4) & (sin_to > 1e-4), torch.clamp(cos_diff, min=0.0), 0.0)
    aci, aco = abs_cos_theta(wi), abs_cos_theta(wo)
    sin_a = torch.where(aci > aco, sin_to, sin_ti)
    tan_b = torch.where(aci > aco, sin_ti / torch.clamp(aci, min=1e-7),
                        sin_to / torch.clamp(aco, min=1e-7))
    return r * (INV_PI * (a + b * max_cos * sin_a * tan_b))[..., None]


def fr_dielectric(cos_i, eta_i, eta_t):
    """Fresnel reflectance of a dielectric (reflection.rs fr_dielectric)."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = cos_i.abs()
    sin_t = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_parl = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-20)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-20)
    return torch.where(sin_t >= 1.0, 1.0, 0.5 * (r_parl * r_parl + r_perp * r_perp))


# ---- the TrowbridgeReitz (GGX) distribution (microfacet.rs) ----

def tr_roughness_to_alpha(roughness):
    """microfacet.rs:243."""
    x = torch.log(torch.clamp(roughness, min=1e-3))
    return 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3 + 0.000640711 * x ** 4


def tr_d(wh, ax, ay):
    t2 = tan2_theta(wh)
    c4 = cos2_theta(wh) ** 2
    e = (cos_phi(wh) ** 2 / torch.clamp(ax * ax, min=1e-12)
         + sin_phi(wh) ** 2 / torch.clamp(ay * ay, min=1e-12)) * t2
    d = 1.0 / (PI * ax * ay * c4 * (1.0 + e) ** 2)
    return torch.where(torch.isfinite(t2) & (c4 > 1e-16), d, 0.0)


def tr_lambda(w, ax, ay):
    abs_tan = torch.sqrt(torch.clamp(tan2_theta(w), min=0.0))
    alpha = torch.sqrt(torch.clamp(cos_phi(w) ** 2 * ax * ax + sin_phi(w) ** 2 * ay * ay,
                                   min=1e-12))
    lam = (-1.0 + torch.sqrt(1.0 + (alpha * abs_tan) ** 2)) / 2.0
    return torch.where(torch.isfinite(abs_tan), lam, 0.0)


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_sample_wh(wo, u, ax, ay):
    """Visible-normal sampling (Heitz 2018), distribution-equal to
    microfacet.rs sample_wh with sample_visible_area (bsdf.py:185)."""
    sign = torch.sign(torch.where(cos_theta(wo) == 0.0, 1.0, cos_theta(wo)))
    wo_s = wo * sign[..., None]
    vh = vm.normalize(torch.stack([ax * wo_s[..., 0], ay * wo_s[..., 1], wo_s[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where((lensq > 1e-14)[..., None],
                     torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                                  torch.zeros_like(inv_len)], -1),
                     torch.tensor([1.0, 0.0, 0.0], device=wo.device).expand_as(wo))
    t2 = vm.cross(vh, t1)
    d = concentric_sample_disk(u)
    p1 = d[..., 0]
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * d[..., 1]
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    wh = vm.normalize(torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                                   torch.clamp(nh[..., 2], min=1e-6)], -1))
    return wh * sign[..., None]


def tr_pdf_wh(wo, wh, ax, ay):
    """The pdf of tr_sample_wh: D G1 |wo.wh| / |cos wo|."""
    return (tr_d(wh, ax, ay) * tr_g1(wo, ax, ay) * vm.absdot(wo, wh)
            / torch.clamp(abs_cos_theta(wo), min=1e-7))


def _trans_eta(wo, eta):
    """The relative index of a transmission with air outside: eta entering
    (cos wo > 0), else 1 / eta (reflection.rs MicrofacetTransmission::f)."""
    return torch.where(cos_theta(wo) > 0.0, eta, 1.0 / torch.clamp(eta, min=1e-6))


def _microfacet_trans_f(color, wo, wi, ax, ay, eta):
    """MicrofacetTransmission::f (reflection.rs:1246-1313), radiance
    transport (the factor 1 / eta)."""
    cto, cti = cos_theta(wo), cos_theta(wi)
    e = _trans_eta(wo, eta)
    wh = vm.normalize(wo + wi * e[..., None])
    wh = wh * torch.sign(wh[..., 2:3])
    dot_o, dot_i = vm.dot(wo, wh), vm.dot(wi, wh)
    fr = fr_dielectric(dot_o, torch.ones_like(eta), eta)
    sqrt_denom = dot_o + e * dot_i
    factor = 1.0 / torch.clamp(e, min=1e-6)
    val = (1.0 - fr)[..., None] * color * (
        tr_d(wh, ax, ay) * tr_g(wo, wi, ax, ay) * e * e * dot_i.abs() * dot_o.abs() * factor
        * factor / torch.clamp((cti * cto * sqrt_denom * sqrt_denom).abs(), min=1e-12)
    ).abs()[..., None]
    ok = (cto != 0.0) & (cti != 0.0) & (dot_o * dot_i <= 0.0)
    return torch.where(ok[..., None], val, 0.0)


def _microfacet_trans_pdf(wo, wi, ax, ay, eta):
    """MicrofacetTransmission::pdf (reflection.rs:1348-1370): the pdf of wh
    times |dwh/dwi|."""
    e = _trans_eta(wo, eta)
    wh = vm.normalize(wo + wi * e[..., None])
    dot_o, dot_i = vm.dot(wo, wh), vm.dot(wi, wh)
    sqrt_denom = dot_o + e * dot_i
    dwh_dwi = (e * e * dot_i / torch.clamp(sqrt_denom * sqrt_denom, min=1e-12)).abs()
    # tr_sample_wh gives wh in wo's hemisphere
    wh_s = wh * torch.sign(wh[..., 2:3]) * torch.sign(cos_theta(wo))[..., None]
    pdf = tr_pdf_wh(wo, wh_s, ax, ay) * dwh_dwi
    return torch.where(~same_hemisphere(wo, wi) & (dot_o * dot_i <= 0.0), pdf, 0.0)


class Bsdf(NamedTuple):
    """Two lobe slots per lane (the JAX package's slots 0 and 1).  The
    microfacet lobes read their alphas from ax and ay; the hair lobe reads
    sigma_a from r0, beta_m from ax, beta_n from ay, alpha (degrees) from
    sigma, eta and the fibre offset h.  FresnelSpecular transmits kt."""

    kind0: torch.Tensor  # (N,) lobe tags
    kind1: torch.Tensor
    r0: torch.Tensor  # (N,3) lobe colors (kd, kr; hair: sigma_a)
    r1: torch.Tensor  # (N,3) (rough glass: kt)
    sigma: torch.Tensor  # (N,) Oren-Nayar sigma, hair alpha, degrees
    ax: torch.Tensor  # (N,) microfacet alpha x; hair beta_m
    ay: torch.Tensor  # (N,) microfacet alpha y; hair beta_n
    eta: torch.Tensor  # (N,) index of refraction (glass, hair)
    h: torch.Tensor  # (N,) hair offset across the fibre, -1 + 2 v
    enable_hair: bool = True  # False: no lane has the hair lobe (its math is skipped)
    kt: torch.Tensor = None  # (N,3) smooth glass's transmission color
    enable_glass: bool = True  # False: no lane has a glass lobe (their math is skipped)
    enable_microfacet: bool = True  # False: no lane has a microfacet lobe (rough glass)


# ---- the hair lobe (materials/hair.rs:178-790, Marschner/Chiang) ----
# In the BSDF frame x is the fibre's tangent: wo.x = sin(theta_o), and the
# azimuth phi = atan2(w.z, w.y).

HAIR_P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def _hair_i0(x):
    """The modified Bessel function I0 by the reference's 10-term series
    (hair.rs:679)."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact, i4 = 1.0, 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def _hair_log_i0(x):
    xm = torch.clamp(x, min=1e-12)
    big = x + 0.5 * (-math.log(2.0 * PI) + torch.log(1.0 / xm) + 1.0 / (8.0 * xm))
    return torch.where(x > 12.0, big, torch.log(torch.clamp(_hair_i0(x), min=1e-37)))


def _hair_v_terms(v):
    """The parts of Mp that depend on the variance v alone: (v, 1 / v,
    log(1 / (2 v)), sinh(1 / v) 2 v)."""
    inv = 1.0 / v
    return v, inv, torch.log(1.0 / (2.0 * v)), torch.sinh(inv) * 2.0 * v


def _hair_mp(cos_ti, cos_to, sin_ti, sin_to, vt):
    """Longitudinal scattering Mp (hair.rs:660); vt = _hair_v_terms(v)."""
    v, inv, log_c, sinh_c = vt
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = torch.exp(_hair_log_i0(a) - b - inv + 0.6931 + log_c)
    large = torch.exp(-b) * _hair_i0(a) / sinh_c
    return torch.where(v <= 0.1, small, large)


def _hair_derived(beta_m, beta_n, alpha_deg):
    """The lobes' longitudinal variances v[0..3], the azimuthal scale s and
    the scale tilt's sin/cos of 2^k alpha (hair.rs:196-268)."""
    bm2 = beta_m * beta_m
    bm4 = bm2 * bm2
    bm20 = bm4 * bm4 * bm4 * bm4 * bm4
    f = 0.726 * beta_m + 0.812 * bm2 + 3.7 * bm20
    v0 = f * f
    v = [torch.clamp(x, min=1e-7) for x in (v0, 0.25 * v0, 4.0 * v0, 4.0 * v0)]
    bn2 = beta_n * beta_n
    bn4 = bn2 * bn2
    bn22 = bn4 * bn4 * bn4 * bn4 * bn4 * bn2
    s = torch.clamp(SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * bn2 + 5.372 * bn22), min=1e-5)
    sin2k = [torch.sin(alpha_deg * (PI / 180.0))]
    cos2k = [_safe_sqrt(1.0 - sin2k[0] * sin2k[0])]
    for _ in range(2):
        sin2k.append(2.0 * cos2k[-1] * sin2k[-1])
        # the JAX package squares the sin just appended (hair.rs squares
        # the previous one); the port follows the JAX package
        cos2k.append(cos2k[-1] * cos2k[-1] - sin2k[-1] * sin2k[-1])
    return v, s, sin2k, cos2k


def _hair_common(b: Bsdf, wo):
    sin_to = wo[:, 0]
    cos_to = _safe_sqrt(1.0 - sin_to * sin_to)
    phi_o = torch.atan2(wo[:, 2], wo[:, 1])
    sin_tt = sin_to / b.eta
    cos_tt = _safe_sqrt(1.0 - sin_tt * sin_tt)
    etap = _safe_sqrt(b.eta * b.eta - sin_to * sin_to) / torch.clamp(cos_to, min=1e-7)
    sin_gt = b.h / etap
    cos_gt = _safe_sqrt(1.0 - sin_gt * sin_gt)
    gamma_t = torch.asin(torch.clamp(sin_gt, -1.0, 1.0))
    gamma_o = torch.asin(torch.clamp(b.h, -1.0, 1.0))
    # single-pass transmittance through the fibre (hair.rs:358)
    t = torch.exp(-b.r0 * (2.0 * cos_gt / torch.clamp(cos_tt, min=1e-7))[:, None])
    return sin_to, cos_to, phi_o, gamma_o, gamma_t, t


def _hair_ap(cos_to, eta, h, t):
    """The attenuations A_p, p = 0..3 (hair.rs:707)."""
    cos_go = _safe_sqrt(1.0 - h * h)
    f = fr_dielectric(cos_to * cos_go, torch.ones_like(eta), eta)[:, None]
    ap = [f.expand_as(t)]
    ap.append(t * ((1.0 - f) * (1.0 - f)))
    ap.append(ap[1] * t * f)
    ap.append(ap[2] * t * f / torch.clamp(1.0 - t * f, min=1e-4))
    return ap


def _hair_np_terms(p, s, gamma_o, gamma_t):
    """The parts of Np that do not depend on wi: the lobe's azimuth
    phi(p) and the trimmed logistic's normalization (hair.rs:752)."""
    cdf = lambda y: 1.0 / (1.0 + torch.exp(-y / s))
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * PI, cdf(PI) - cdf(-PI)


def _hair_np(phi, s, off, norm):
    """Azimuthal scattering Np: the trimmed logistic about phi(p) = off
    (hair.rs:752)."""
    dphi = phi - off
    dphi = torch.remainder(dphi + PI, 2.0 * PI) - PI
    e = torch.exp(-dphi.abs() / s)
    logistic = e / (s * ((1.0 + e) * (1.0 + e)))
    return logistic / norm


def _hair_tilt(p, sin_to, cos_to, sin2k, cos2k):
    """sin and cos of theta_o tilted by the scales for lobe p
    (hair.rs:363-387)."""
    if p == 0:
        st = sin_to * cos2k[1] - cos_to * sin2k[1]
        ct = cos_to * cos2k[1] + sin_to * sin2k[1]
    elif p == 1:
        st = sin_to * cos2k[0] + cos_to * sin2k[0]
        ct = cos_to * cos2k[0] - sin_to * sin2k[0]
    elif p == 2:
        st = sin_to * cos2k[2] + cos_to * sin2k[2]
        ct = cos_to * cos2k[2] - sin_to * sin2k[2]
    else:
        return sin_to, cos_to
    return st, ct.abs()


def _luminance(c):
    return 0.212671 * c[:, 0] + 0.715160 * c[:, 1] + 0.072169 * c[:, 2]


def _hair_ap_pdf(b: Bsdf, cos_to, t):
    ys = [_luminance(a) for a in _hair_ap(cos_to, b.eta, b.h, t)]
    total = torch.clamp(ys[0] + ys[1] + ys[2] + ys[3], min=1e-12)
    return [y / total for y in ys]


def hair_wo_terms(b: Bsdf, wo):
    """Everything of HairBSDF::f that depends on wo alone, per lane: the
    variances' Mp terms (4), the tilted sin/cos of theta_o (3 each), sin
    and cos of theta_o, phi_o, s, the lobes' Np terms (3 each) and the
    attenuations A_p (4 of (N, 3))."""
    v, s, sin2k, cos2k = _hair_derived(b.ax, b.ay, b.sigma)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, t = _hair_common(b, wo)
    return dict(vt=[_hair_v_terms(x) for x in v],
                tilts=[_hair_tilt(p, sin_to, cos_to, sin2k, cos2k) for p in range(HAIR_P_MAX)],
                sin_to=sin_to, cos_to=cos_to, phi_o=phi_o, s=s,
                np=[_hair_np_terms(p, s, gamma_o, gamma_t) for p in range(HAIR_P_MAX)],
                ap=_hair_ap(cos_to, b.eta, b.h, t))


def hair_f(b: Bsdf, wo, wi):
    """HairBSDF::f (hair.rs:325-417)."""
    w = hair_wo_terms(b, wo)
    sin_ti = wi[:, 0]
    cos_ti = _safe_sqrt(1.0 - sin_ti * sin_ti)
    phi = torch.atan2(wi[:, 2], wi[:, 1]) - w["phi_o"]
    ap = w["ap"]
    fsum = torch.zeros_like(ap[0])
    for p in range(HAIR_P_MAX):
        st, ct = w["tilts"][p]
        mp = _hair_mp(cos_ti, ct, sin_ti, st, w["vt"][p])
        fsum = fsum + ap[p] * (mp * _hair_np(phi, w["s"], *w["np"][p]))[:, None]
    mp_last = _hair_mp(cos_ti, w["cos_to"], sin_ti, w["sin_to"], w["vt"][HAIR_P_MAX])
    fsum = fsum + ap[HAIR_P_MAX] * (mp_last / (2.0 * PI))[:, None]
    aci = wi[:, 2].abs()
    fsum = torch.where(aci[:, None] > 0.0, fsum / torch.clamp(aci, min=1e-7)[:, None], fsum)
    return torch.nan_to_num(fsum, nan=0.0, posinf=0.0)


def _hair_pdf_lobes(ap_pdf, cos_ti, sin_ti, dphi, tilts, v, s, gamma_o, gamma_t, sin_to, cos_to):
    pdf = torch.zeros_like(cos_ti)
    for p in range(HAIR_P_MAX):
        st, ct = tilts[p]
        pdf = pdf + ap_pdf[p] * _hair_mp(cos_ti, ct, sin_ti, st, _hair_v_terms(v[p])) * _hair_np(
            dphi, s, *_hair_np_terms(p, s, gamma_o, gamma_t))
    pdf = pdf + ap_pdf[HAIR_P_MAX] * _hair_mp(cos_ti, cos_to, sin_ti, sin_to,
                                              _hair_v_terms(v[HAIR_P_MAX])) * (1.0 / (2.0 * PI))
    return torch.nan_to_num(pdf, nan=0.0, posinf=0.0)


def hair_pdf(b: Bsdf, wo, wi):
    """HairBSDF::pdf (hair.rs:553-622)."""
    v, s, sin2k, cos2k = _hair_derived(b.ax, b.ay, b.sigma)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, t = _hair_common(b, wo)
    sin_ti = wi[:, 0]
    cos_ti = _safe_sqrt(1.0 - sin_ti * sin_ti)
    phi = torch.atan2(wi[:, 2], wi[:, 1]) - phi_o
    tilts = [_hair_tilt(p, sin_to, cos_to, sin2k, cos2k) for p in range(HAIR_P_MAX)]
    return _hair_pdf_lobes(_hair_ap_pdf(b, cos_to, t), cos_ti, sin_ti, phi, tilts, v, s,
                           gamma_o, gamma_t, sin_to, cos_to)


def _compact_1_by_1(x):
    """The even bits of x (int64 holding a uint32) packed into its low 16."""
    x = x & 0x55555555
    x = (x ^ (x >> 1)) & 0x33333333
    x = (x ^ (x >> 2)) & 0x0F0F0F0F
    x = (x ^ (x >> 4)) & 0x00FF00FF
    return (x ^ (x >> 8)) & 0x0000FFFF


def _demux_float(f):
    """Two uniforms from one by de-interleaving its bits (hair.rs:647): the
    32-bit fixed-point value from two 16-bit halves, in int64 (torch has no
    uint32 arithmetic)."""
    f = torch.clamp(f, 0.0, 0.99999994)
    hi16 = torch.floor(f * 65536.0)
    lo16 = torch.floor((f * 65536.0 - hi16) * 65536.0)
    v = (hi16.to(torch.int64) << 16) | torch.clamp(lo16, max=65535.0).to(torch.int64)
    a = _compact_1_by_1(v).to(torch.float32) / 65536.0
    b = _compact_1_by_1(v >> 1).to(torch.float32) / 65536.0
    return a, b


def hair_sample(b: Bsdf, wo, u2):
    """HairBSDF::sample_f (hair.rs:418-552): (wi, pdf)."""
    v, s, sin2k, cos2k = _hair_derived(b.ax, b.ay, b.sigma)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, t = _hair_common(b, wo)
    u0x, u0y = _demux_float(u2[:, 0])
    u1x, u1y = _demux_float(u2[:, 1])
    ap_pdf = _hair_ap_pdf(b, cos_to, t)
    # the lobe p by ap_pdf (hair.rs:439-446)
    c0 = ap_pdf[0]
    c1 = c0 + ap_pdf[1]
    c2 = c1 + ap_pdf[2]
    p_idx = (u0x >= c0).to(torch.int64) + (u0x >= c1).to(torch.int64) + (u0x >= c2).to(torch.int64)

    tilts = [_hair_tilt(p, sin_to, cos_to, sin2k, cos2k) for p in range(HAIR_P_MAX + 1)]
    pick = lambda xs: torch.stack(xs, -1).gather(1, p_idx[:, None])[:, 0]
    sin_top = pick([st for st, _ in tilts])
    cos_top = pick([ct for _, ct in tilts])
    vp = pick(v)
    # the longitudinal sample (hair.rs:463-477)
    u1x = torch.clamp(u1x, min=1e-5)
    cos_theta = 1.0 + vp * torch.log(u1x + (1.0 - u1x) * torch.exp(-2.0 / vp))
    sin_theta = _safe_sqrt(1.0 - cos_theta * cos_theta)
    cos_phi_l = torch.cos(2.0 * PI * u1y)
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi_l * cos_top
    cos_ti = _safe_sqrt(1.0 - sin_ti * sin_ti)
    # the azimuthal sample (hair.rs:479-491): the trimmed logistic about phi(p)
    k = 1.0 / (1.0 + torch.exp(-PI / s)) - 1.0 / (1.0 + torch.exp(PI / s))
    cdf_a = 1.0 / (1.0 + torch.exp(PI / s))
    x = -s * torch.log(1.0 / torch.clamp(u0y * k + cdf_a, 1e-7, 1.0 - 1e-7) - 1.0)
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), -PI, PI)
    pf = 2.0 * p_idx.to(torch.float32) * gamma_t - 2.0 * gamma_o + p_idx * PI
    dphi = torch.where(p_idx < HAIR_P_MAX, pf + x, 2.0 * PI * u0y)
    phi_i = phi_o + dphi
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i), cos_ti * torch.sin(phi_i)], -1)
    # the pdf over every lobe (hair.rs:500-546)
    pdf = _hair_pdf_lobes(ap_pdf, cos_ti, sin_ti, dphi, tilts, v, s, gamma_o, gamma_t, sin_to,
                          cos_to)
    return wi, pdf


class BsdfSample(NamedTuple):
    wi: torch.Tensor  # (N,3) local
    f: torch.Tensor  # (N,3)
    pdf: torch.Tensor  # (N,)
    is_specular: torch.Tensor  # (N,) bool
    is_transmission: torch.Tensor  # (N,) bool


def check_supported(scene: sa.Scene):
    """Raises NotImplementedError for materials the port cannot shade yet."""
    if scene.mat_kind_mask & ~PORTED_MATERIALS:
        raise NotImplementedError("only the subsurface, matte, mirror, glass and hair materials "
                                  "are ported so far (ROADMAP queue A)")
    if scene.tex_slot_mask:
        raise NotImplementedError("textured material parameters are not ported yet "
                                  "(ROADMAP queue A)")


def make_bsdf(mat_type, params, uv=None, enable_hair: bool = True,
              enable_glass: bool = True, enable_microfacet: bool = True) -> Bsdf:
    """Material tags (N,) and parameter rows (N, N_MAT_PARAMS) -> Bsdf
    (material.rs compute_scattering_functions for matte, mirror, glass,
    hair and subsurface).  uv (N, 2): the hits' coordinates, whose v gives a fibre's
    offset h (0 without uv).  enable_hair / enable_glass /
    enable_microfacet False: the scene has no hair / no glass (nor
    subsurface) / no rough glass (those lobes' math is skipped; the tags
    still say which lobe a lane has)."""
    n = mat_type.shape[0]
    kd = params[:, sa.MP_KD:sa.MP_KD + 3]
    kr = params[:, sa.MP_KR:sa.MP_KR + 3]
    kt = params[:, sa.MP_KT:sa.MP_KT + 3]
    sigma = params[:, sa.MP_SIGMA]
    rough_u, rough_v = params[:, sa.MP_ROUGH_U], params[:, sa.MP_ROUGH_V]
    if enable_microfacet:
        remap = params[:, sa.MP_REMAP_ROUGH] > 0.5
        ax = torch.clamp(torch.where(remap, tr_roughness_to_alpha(rough_u), rough_u), min=1e-4)
        ay = torch.clamp(torch.where(remap, tr_roughness_to_alpha(rough_v), rough_v), min=1e-4)
    else:
        ax = ay = torch.zeros_like(sigma)
    is_black = lambda c: (c == 0.0).all(-1)
    kind0 = torch.full((n,), LOBE_NONE, dtype=torch.int32, device=params.device)
    kind1 = torch.full_like(kind0, LOBE_NONE)
    r0 = torch.zeros((n, 3), dtype=torch.float32, device=params.device)
    r1 = torch.zeros_like(r0)
    # matte (materials/matte.rs): Lambert, or Oren-Nayar for sigma > 0
    m = mat_type == sa.MATTE
    kind0 = torch.where(m & ~is_black(kd),
                        torch.where(sigma == 0.0, LOBE_LAMBERT, LOBE_ORENNAYAR).to(torch.int32),
                        kind0)
    r0 = torch.where(m[:, None], kd, r0)
    # mirror (materials/mirror.rs): perfect specular, the Fresnel term is 1
    m = mat_type == sa.MIRROR
    kind0 = torch.where(m & ~is_black(kr), LOBE_SPEC_REFL, kind0)
    r0 = torch.where(m[:, None], kr, r0)
    # glass (materials/glass.rs:107-205): FresnelSpecular when smooth, else
    # microfacet reflection (kr) and transmission (kt); the subsurface
    # material (materials/subsurface.rs) has the same surface lobes, its
    # BSSRDF is the integrators' (path.sss_transport)
    m = (mat_type == sa.GLASS) | (mat_type == sa.SUBSURFACE)
    smooth = (rough_u <= 0.0) & (rough_v <= 0.0)
    kind0 = torch.where(m & ~(~smooth & is_black(kr)),
                        torch.where(smooth, LOBE_FRESNEL_SPEC,
                                    LOBE_MICROFACET_REFL).to(torch.int32), kind0)
    kind1 = torch.where(m & ~smooth & ~is_black(kt), LOBE_MICROFACET_TRANS, kind1)
    r0 = torch.where(m[:, None], kr, r0)
    r1 = torch.where((m & ~smooth)[:, None], kt, r1)
    # hair (materials/hair.rs): one Marschner lobe; MP_KD holds sigma_a, or
    # the color, converted here (sigma_a_from_reflectance)
    m = mat_type == sa.HAIR
    kind0 = torch.where(m, LOBE_HAIR, kind0)
    bn = torch.clamp(rough_v, 1e-3, 1.0)
    denom_sa = (5.969 - 0.215 * bn + 2.532 * bn ** 2 - 10.73 * bn ** 3 + 5.574 * bn ** 4
                + 0.245 * bn ** 5)
    f_sa = torch.log(torch.clamp(kd, 1e-5, 1.0)) / denom_sa[:, None]
    from_color = (params[:, sa.MP_HAIR_MODE] > 0.5)[:, None]
    r0 = torch.where(m[:, None], torch.where(from_color, f_sa * f_sa, kd), r0)
    ax = torch.where(m, torch.clamp(rough_u, 1e-3, 1.0), ax)
    ay = torch.where(m, bn, ay)
    eta = torch.where(params[:, sa.MP_ETA] > 0.0, params[:, sa.MP_ETA], 1.0)
    h = (torch.zeros_like(sigma) if uv is None
         else torch.clamp(-1.0 + 2.0 * uv[:, 1], -1.0, 1.0))
    return Bsdf(kind0, kind1, r0, r1, sigma, ax, ay, eta, h, enable_hair, kt, enable_glass,
                enable_microfacet and enable_glass)


def make_bsdf_from_mat(scene: sa.Scene, mat, uv=None) -> Bsdf:
    """The Bsdf of material ids mat (N,) (and, in a scene with hair, of the
    hits' uv; without uv a fibre's offset is 0, as the JAX package's
    make_bsdf_from_mat gives SPPM's visible points)."""
    check_supported(scene)
    ma = scene.mat_attr[mat.long()]
    return make_bsdf(torch.round(ma[:, sa.MA_TYPE]).to(torch.int32),
                     ma[:, sa.MA_PARAMS:sa.MA_PARAMS + sa.N_MAT_PARAMS],
                     uv if scene.has_hair else None, scene.has_hair,
                     bool(scene.mat_kind_mask & ((1 << sa.GLASS) | (1 << sa.SUBSURFACE))),
                     scene.has_rough_glass)


def make_bsdf_at(scene: sa.Scene, it) -> Bsdf:
    """The Bsdf at each hit of an Interaction, from its material id (and,
    in a scene with hair, its uv)."""
    return make_bsdf_from_mat(scene, it.mat, it.uv if scene.has_hair else None)


def num_components(b: Bsdf):
    return (b.kind0 != LOBE_NONE).to(torch.int32) + (b.kind1 != LOBE_NONE).to(torch.int32)


def has_nonspecular(b: Bsdf):
    """Any non-specular lobe in either slot (Bsdf::num_components without
    BSDF_SPECULAR)."""
    non = lambda k: (k != LOBE_NONE) & (k != LOBE_SPEC_REFL) & (k != LOBE_FRESNEL_SPEC)
    return non(b.kind0) | non(b.kind1)


def _lobe_f(kind, color, b: Bsdf, wo, wi, reflect):
    """One lobe slot's f for all lanes (specular lobes give 0)."""
    out = torch.where((kind == LOBE_LAMBERT)[:, None], color * INV_PI, 0.0)
    out = torch.where((kind == LOBE_ORENNAYAR)[:, None], oren_nayar_f(color, b.sigma, wo, wi), out)
    if b.enable_microfacet:
        # MicrofacetReflection with the dielectric Fresnel term, wh facing
        # forward (reflection.rs MicrofacetReflection::f)
        wh = wi + wo
        wh_ok = (wh != 0.0).any(-1) & (abs_cos_theta(wi) > 0) & (abs_cos_theta(wo) > 0)
        wh_n = vm.normalize(wh)
        wh_f = wh_n * torch.sign(wh_n[..., 2:3])
        denom = 4.0 * abs_cos_theta(wi) * abs_cos_theta(wo)
        f_mf = torch.where((wh_ok & (denom > 0))[:, None],
                           color * (tr_d(wh_n, b.ax, b.ay) * tr_g(wo, wi, b.ax, b.ay)
                                    / torch.clamp(denom, min=1e-12))[:, None], 0.0)
        fr = fr_dielectric(vm.dot(wi, wh_f), torch.ones_like(b.eta), b.eta)
        out = torch.where((kind == LOBE_MICROFACET_REFL)[:, None], f_mf * fr[:, None], out)
    # reflective lobes contribute only on the reflecting side, with wo and wi
    # in the same shading hemisphere
    out = torch.where((reflect & same_hemisphere(wo, wi))[:, None], out, 0.0)
    if b.enable_microfacet:
        ft = _microfacet_trans_f(color, wo, wi, b.ax, b.ay, b.eta)
        out = torch.where((kind == LOBE_MICROFACET_TRANS)[:, None],
                          torch.where((~same_hemisphere(wo, wi) & ~reflect)[:, None], ft, 0.0),
                          out)
    return out


def _lobe_pdf(kind, b: Bsdf, wo, wi):
    pdf_cos = abs_cos_theta(wi) * INV_PI
    out = torch.where((kind == LOBE_LAMBERT) | (kind == LOBE_ORENNAYAR), pdf_cos, 0.0)
    if b.enable_microfacet:
        wh = vm.normalize(wi + wo)
        pdf_mf = tr_pdf_wh(wo, wh, b.ax, b.ay) / torch.clamp(4.0 * vm.dot(wo, wh), min=1e-12)
        out = torch.where(kind == LOBE_MICROFACET_REFL, pdf_mf, out)
    out = torch.where(same_hemisphere(wo, wi), out, 0.0)
    if b.enable_microfacet:
        out = torch.where(kind == LOBE_MICROFACET_TRANS,
                          _microfacet_trans_pdf(wo, wi, b.ax, b.ay, b.eta), out)
    return out


def bsdf_f(b: Bsdf, wo, wi, reflect):
    """f summed over the non-specular lobes (reflection.rs:355 Bsdf::f); the
    hair lobe (slot 0) over the whole sphere."""
    f = _lobe_f(b.kind0, b.r0, b, wo, wi, reflect) + _lobe_f(b.kind1, b.r1, b, wo, wi, reflect)
    if b.enable_hair:
        f = torch.where((b.kind0 == LOBE_HAIR)[:, None], hair_f(b, wo, wi), f)
    return f


def bsdf_pdf(b: Bsdf, wo, wi):
    """The pdf averaged over the components (Bsdf::pdf)."""
    p0 = _lobe_pdf(b.kind0, b, wo, wi)
    if b.enable_hair:
        p0 = torch.where(b.kind0 == LOBE_HAIR, hair_pdf(b, wo, wi), p0)
    p = p0 + _lobe_pdf(b.kind1, b, wo, wi)
    n = num_components(b)
    return torch.where(n > 0, p / torch.clamp(n.to(torch.float32), min=1.0), 0.0)


def bsdf_sample(b: Bsdf, wo, u2, uc) -> BsdfSample:
    """Importance-sample the BSDF (reflection.rs:280 Bsdf::sample_f): uc
    picks a present lobe slot, u2 samples it (cosine hemisphere, the mirror
    direction, a visible microfacet normal to reflect or refract through,
    Fresnel's choice of smooth glass's reflection or refraction by u2.x, or
    the hair lobe); f and pdf combine the non-specular lobes."""
    n_comp = num_components(b).to(torch.float32)
    pick1 = (uc * torch.clamp(n_comp, min=1.0)) >= 1.0
    kind = torch.where(pick1, b.kind1, b.kind0)
    color = torch.where(pick1[:, None], b.r1, b.r0)
    wi = cosine_sample_hemisphere(u2)
    wi = wi * torch.sign(torch.where(cos_theta(wo) == 0, 1.0, cos_theta(wo)))[:, None]
    is_spec_r = kind == LOBE_SPEC_REFL
    wi_spec = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    is_mf = kind == LOBE_MICROFACET_REFL
    is_mft = kind == LOBE_MICROFACET_TRANS
    is_fs = kind == LOBE_FRESNEL_SPEC
    entering = cos_theta(wo) > 0.0
    fr = fr_dielectric(cos_theta(wo), torch.ones_like(b.eta), b.eta)
    choose_refl = u2[:, 0] < fr
    ok_t = mft_ok = torch.ones_like(entering)
    if b.enable_microfacet:
        # glossy reflection and transmission through a sampled wh
        # (MicrofacetTransmission::sample_f, reflection.rs:1316-1346)
        wh = tr_sample_wh(wo, u2, b.ax, b.ay)
        wi = torch.where(is_mf[:, None], reflect_dir(wo, wh), wi)
        wh_side = wh * torch.sign(vm.dot(wo, wh))[:, None]
        ok_rt, wi_rt = refract_dir(wo, wh_side, torch.where(entering, 1.0 / b.eta, b.eta))
        wi = torch.where(is_mft[:, None], wi_rt, wi)
        mft_ok = torch.where(is_mft, ok_rt, mft_ok)
    wi = torch.where(is_spec_r[:, None], wi_spec, wi)
    if b.enable_glass:
        # smooth glass: reflect with Fresnel's probability, else refract
        # (FresnelSpecular::sample_f)
        n_up = torch.tensor([0.0, 0.0, 1.0], device=wo.device).expand_as(wo)
        ok_t, wi_t = refract_dir(wo, torch.where(entering[:, None], n_up, -n_up),
                                 torch.where(entering, 1.0 / b.eta, b.eta))
        wi = torch.where(is_fs[:, None], torch.where(choose_refl[:, None], wi_spec, wi_t), wi)
    if b.enable_hair:
        wi = torch.where((kind == LOBE_HAIR)[:, None], hair_sample(b, wo, u2)[0], wi)
    wi = vm.normalize(wi)
    is_specular = is_spec_r | is_fs
    # delta lobes: the pdf of the discrete choice (Fresnel's for smooth
    # glass) over the components
    pdf_delta = torch.where(is_fs, torch.where(choose_refl, fr, 1.0 - fr), 1.0)
    pdf = torch.where(is_specular, pdf_delta / torch.clamp(n_comp, min=1.0),
                      bsdf_pdf(b, wo, wi))
    f = bsdf_f(b, wo, wi, same_hemisphere(wo, wi))
    # the mirror's f = R / |cos wi|, the delta absorbed
    aci = torch.clamp(abs_cos_theta(wi), min=1e-7)
    f = torch.where(is_spec_r[:, None], color / aci[:, None], f)
    if b.enable_glass:
        # radiance transport scales refraction by (eta_i / eta_t)^2
        scale_t = torch.where(entering, 1.0 / (b.eta * b.eta), b.eta * b.eta)
        f_fs = torch.where(choose_refl[:, None], (fr / aci)[:, None] * b.r0,
                           ((1.0 - fr) * scale_t / aci)[:, None] * b.kt)
        f_fs = torch.where((is_fs & ~choose_refl & ~ok_t)[:, None], 0.0, f_fs)
        f = torch.where(is_fs[:, None], f_fs, f)
    # a microfacet sample below the horizon, or a failed refraction: no sample
    bad = (is_mf & ~same_hemisphere(wo, wi)) | (is_mft & (same_hemisphere(wo, wi) | ~mft_ok))
    none = (num_components(b) == 0) | bad
    pdf = torch.where(none, 0.0, pdf)
    f = torch.where(none[:, None], 0.0, f)
    return BsdfSample(wi, f, pdf, is_specular, (is_fs & ~choose_refl) | is_mft)
