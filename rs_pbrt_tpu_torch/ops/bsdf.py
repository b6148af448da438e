"""The BSDF of every untextured material of the JAX package as batched
tag-switched code.

The port of the JAX package's ``ops/bsdf.py`` (reference
src/core/reflection.rs, microfacet.rs and materials/*.rs): every lane
carries up to six lobe slots, each a lobe tag and a color, and per-lane
parameters; each lobe family is evaluated for all lanes and selected by
its tag.  The families: Lambert, Oren-Nayar, perfect specular reflection
(with or without a dielectric Fresnel term), FresnelSpecular (smooth
glass), specular transmission, uber's opacity pass-through,
TrowbridgeReitz (or Beckmann) microfacet reflection with a dielectric or
conductor Fresnel term and microfacet transmission, FresnelBlend
(substrate), Lambertian transmission, the Disney diffuse, gloss, clearcoat
and sheen lobes, the Marschner/Chiang hair lobe (hair.rs:178-790) and the
tabulated Fourier lobe (its evaluation and sampling are the kernels F1 and
F2, ``ops/fourier_kernel.py``).  Slots 2-5 exist only where the scene's
material set needs them (uber, translucent, Disney, mix), and each family's
math runs only in the slots where the scene's set holds it (the lobe
masks): a scene of the matte, mirror, glass, hair and subsurface
materials computes what it computed before the other families came.
Textured parameters raise
NotImplementedError (``check_supported``).

Convention: the shading-local frame has z = the shading normal and x the
surface's u tangent (a fibre's direction on curves); wo and wi are unit
vectors in it.  Reflection against transmission is decided on the
geometric normal by the caller (the ``reflect`` flag); the hair and
Fourier lobes scatter over the whole sphere and ignore it.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

from ..scene import arrays as sa
from ..utils import vecmath as vm
from . import fourier_kernel
from .fourier_bsdf import table_of
from .sampling import concentric_sample_disk, cosine_sample_hemisphere

INV_PI = float(vm.INV_PI)

# lobe tags, numbered as in the JAX package
N_LOBE_KINDS = 19
LOBE_NONE = 0
LOBE_LAMBERT = 1
LOBE_ORENNAYAR = 2
LOBE_SPEC_REFL = 3
LOBE_FRESNEL_SPEC = 4  # FresnelSpecular: smooth glass's reflection or refraction
LOBE_MICROFACET_REFL = 5  # MicrofacetReflection with a dielectric Fresnel term
LOBE_FRESNEL_BLEND = 6  # FresnelBlend (substrate)
LOBE_MICROFACET_REFL_COND = 7  # MicrofacetReflection with the conductor Fresnel term
LOBE_DISNEY_DIFFUSE = 8
LOBE_DISNEY_GLOSS = 9
LOBE_HAIR = 10
LOBE_FOURIER = 11
LOBE_LAMBERT_TRANS = 12  # LambertianTransmission
LOBE_MICROFACET_TRANS = 13  # MicrofacetTransmission (reflection.rs:1211)
LOBE_SPEC_TRANS = 14  # SpecularTransmission at the lane's eta (uber kt)
LOBE_SPEC_TRANS_PASS = 15  # SpecularTransmission(t, 1, 1): uber's opacity pass-through
LOBE_SPEC_REFL_FR = 16  # SpecularReflection with a dielectric Fresnel term (uber kr)
LOBE_DISNEY_CLEARCOAT = 17  # disney.rs DisneyClearcoat (GTR1)
LOBE_DISNEY_SHEEN = 18  # disney.rs DisneySheen
SPECULAR_LOBES = (LOBE_SPEC_REFL, LOBE_FRESNEL_SPEC, LOBE_SPEC_REFL_FR, LOBE_SPEC_TRANS,
                  LOBE_SPEC_TRANS_PASS)
# the materials of the earlier slices: make_bsdf's default set, whose lobes
# fit slots 0 and 1
BASE_MATERIALS = ((1 << sa.MATTE) | (1 << sa.MIRROR) | (1 << sa.GLASS) | (1 << sa.HAIR)
                  | (1 << sa.SUBSURFACE))
# the materials with a microfacet lobe besides rough glass and subsurface
MICROFACET_MATERIALS = ((1 << sa.PLASTIC) | (1 << sa.METAL) | (1 << sa.SUBSTRATE)
                        | (1 << sa.UBER) | (1 << sa.TRANSLUCENT) | (1 << sa.DISNEY)
                        | (1 << sa.MIXMAT))
PI = math.pi
FRESNEL_BLEND_K = float(np.float32(28.0) / (np.float32(23.0) * np.float32(np.pi)))  # 28 / (23 pi)


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


def fr_conductor(cos_i, eta_i, eta_t, k):
    """The rgb Fresnel reflectance of a conductor (reflection.rs
    fr_conductor): cos_i (N,), eta_i, eta_t, k (N, 3) -> (N, 3)."""
    ci = torch.clamp(cos_i.abs(), -1.0, 1.0)[:, None]
    eta = eta_t / eta_i
    etak = k / eta_i
    cos2 = ci * ci
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - sin2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * etak2, min=0.0))
    t1 = a2b2 + cos2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rp + rs)


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


# ---- the Beckmann distribution (microfacet.rs:23 Beckmann*): the Bsdf's
# use_beckmann flag picks it; the JAX make_bsdf never sets the flag, so no
# render takes it ----

def bk_d(wh, ax, ay):
    t2 = tan2_theta(wh)
    c4 = cos2_theta(wh) ** 2
    e = torch.exp(-t2 * (cos_phi(wh) ** 2 / torch.clamp(ax * ax, min=1e-12)
                         + sin_phi(wh) ** 2 / torch.clamp(ay * ay, min=1e-12)))
    d = e / (PI * ax * ay * torch.clamp(c4, min=1e-16))
    return torch.where(torch.isfinite(t2) & (c4 > 1e-16), d, 0.0)


def bk_lambda(w, ax, ay):
    """Beckmann's Lambda by the rational approximation (microfacet.rs)."""
    abs_tan = torch.sqrt(torch.clamp(tan2_theta(w), min=0.0))
    alpha = torch.sqrt(torch.clamp(cos_phi(w) ** 2 * ax * ax + sin_phi(w) ** 2 * ay * ay,
                                   min=1e-12))
    a = 1.0 / torch.clamp(alpha * abs_tan, min=1e-12)
    lam = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    lam = torch.where(a >= 1.6, 0.0, lam)
    return torch.where(torch.isfinite(abs_tan), lam, 0.0)


def bk_g1(w, ax, ay):
    return 1.0 / (1.0 + bk_lambda(w, ax, ay))


def bk_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + bk_lambda(wo, ax, ay) + bk_lambda(wi, ax, ay))


def bk_sample_wh(wo, u, ax, ay):
    """wh from the whole distribution (microfacet.rs sample_wh without the
    visible area), flipped into wo's hemisphere."""
    logs = torch.log(torch.clamp(1.0 - u[..., 0], min=1e-20))
    phi = torch.atan(ay / ax * torch.tan(2.0 * PI * u[..., 1] + 0.5 * PI))
    phi = torch.where(u[..., 1] > 0.5, phi + PI, phi)
    sp, cp = torch.sin(phi), torch.cos(phi)
    t2 = -logs / torch.clamp(cp * cp / (ax * ax) + sp * sp / (ay * ay), min=1e-12)
    ct = 1.0 / torch.sqrt(1.0 + t2)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    wh = torch.stack([st * cp, st * sp, ct], -1)
    return torch.where((~same_hemisphere(wo, wh))[..., None], -wh, wh)


def bk_pdf_wh(wo, wh, ax, ay):
    """The pdf of bk_sample_wh: D |cos wh|."""
    return bk_d(wh, ax, ay) * abs_cos_theta(wh)


def _trans_eta(wo, eta):
    """The relative index of a transmission with air outside: eta entering
    (cos wo > 0), else 1 / eta (reflection.rs MicrofacetTransmission::f)."""
    return torch.where(cos_theta(wo) > 0.0, eta, 1.0 / torch.clamp(eta, min=1e-6))


def _microfacet_trans_f(color, wo, wi, ax, ay, eta, d=tr_d, g=tr_g):
    """MicrofacetTransmission::f (reflection.rs:1246-1313), radiance
    transport (the factor 1 / eta); d, g: the distribution's D and G."""
    cto, cti = cos_theta(wo), cos_theta(wi)
    e = _trans_eta(wo, eta)
    wh = vm.normalize(wo + wi * e[..., None])
    wh = wh * torch.sign(wh[..., 2:3])
    dot_o, dot_i = vm.dot(wo, wh), vm.dot(wi, wh)
    fr = fr_dielectric(dot_o, torch.ones_like(eta), eta)
    sqrt_denom = dot_o + e * dot_i
    factor = 1.0 / torch.clamp(e, min=1e-6)
    val = (1.0 - fr)[..., None] * color * (
        d(wh, ax, ay) * g(wo, wi, ax, ay) * e * e * dot_i.abs() * dot_o.abs() * factor
        * factor / torch.clamp((cti * cto * sqrt_denom * sqrt_denom).abs(), min=1e-12)
    ).abs()[..., None]
    ok = (cto != 0.0) & (cti != 0.0) & (dot_o * dot_i <= 0.0)
    return torch.where(ok[..., None], val, 0.0)


def _microfacet_trans_pdf(wo, wi, ax, ay, eta, pdf_wh=tr_pdf_wh):
    """MicrofacetTransmission::pdf (reflection.rs:1348-1370): the pdf of wh
    (the distribution's pdf_wh) times |dwh/dwi|."""
    e = _trans_eta(wo, eta)
    wh = vm.normalize(wo + wi * e[..., None])
    dot_o, dot_i = vm.dot(wo, wh), vm.dot(wi, wh)
    sqrt_denom = dot_o + e * dot_i
    dwh_dwi = (e * e * dot_i / torch.clamp(sqrt_denom * sqrt_denom, min=1e-12)).abs()
    # tr_sample_wh gives wh in wo's hemisphere
    wh_s = wh * torch.sign(wh[..., 2:3]) * torch.sign(cos_theta(wo))[..., None]
    pdf = pdf_wh(wo, wh_s, ax, ay) * dwh_dwi
    return torch.where(~same_hemisphere(wo, wi) & (dot_o * dot_i <= 0.0), pdf, 0.0)


class Bsdf(NamedTuple):
    """Up to six lobe slots per lane (the JAX package's Bsdf).  Slots 0 and
    1 always exist; 2 and 3 where the scene's materials can need more than
    two lobes (uber, translucent, Disney, mix), 4 and 5 where they can need
    five (uber, Disney, mix); None otherwise.  Slots 2 and 3 read their
    alphas, eta and sigma from ax2, ay2, eta2 and sigma2 where those exist
    (Disney and mix scenes: a mix's second material, Disney's clearcoat
    alpha in sigma2); the others read ax, ay, eta and sigma.  The hair lobe
    reads sigma_a from r0, beta_m from ax, beta_n from ay, alpha (degrees)
    from sigma, eta and the fibre offset h.  FresnelSpecular transmits kt.
    A metal's eta and k are eta3 and k3; a Disney lane's k3 holds its thin
    flatness and diffuse transmission.  lobe_mask, slot_masks and
    use_beckmann are static: they say which families' math runs."""

    kind0: torch.Tensor  # (N,) lobe tags
    kind1: torch.Tensor
    r0: torch.Tensor  # (N,3) lobe colors (kd, kr; hair: sigma_a)
    r1: torch.Tensor  # (N,3) (rough glass: kt)
    sigma: torch.Tensor  # (N,) Oren-Nayar sigma, hair alpha, degrees; Disney roughness
    ax: torch.Tensor  # (N,) microfacet alpha x; hair beta_m
    ay: torch.Tensor  # (N,) microfacet alpha y; hair beta_n
    eta: torch.Tensor  # (N,) index of refraction (glass, hair)
    h: torch.Tensor  # (N,) hair offset across the fibre, -1 + 2 v
    kt: torch.Tensor = None  # (N,3) smooth glass's transmission color
    eta3: torch.Tensor = None  # (N,3) conductor eta
    k3: torch.Tensor = None  # (N,3) conductor k; Disney (flatness, diffTrans / 2, 0)
    kind2: torch.Tensor = None  # (N,) slots 2-5, or None
    kind3: torch.Tensor = None
    kind4: torch.Tensor = None
    kind5: torch.Tensor = None
    r2: torch.Tensor = None  # (N,3)
    r3: torch.Tensor = None
    r4: torch.Tensor = None
    r5: torch.Tensor = None
    ax2: torch.Tensor = None  # (N,) slots 2 and 3's parameters, or None
    ay2: torch.Tensor = None
    eta2: torch.Tensor = None
    sigma2: torch.Tensor = None
    lobe_mask: int = -1  # bit k set when lobe tag k may occur (all bits: any)
    slot_masks: tuple = None  # each slot's lobe_mask (slot_lobe_masks), or None: lobe_mask
    fou: object = None  # the scene's FourierTable (ops/fourier_bsdf.py), or None
    use_beckmann: bool = False  # the Beckmann distribution for the microfacet lobes


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


# ---- the Disney lobes (materials/disney.rs) ----

def _pow5(v):
    return (v * v) * (v * v) * v


def _lerp(t, a, b):
    return (1.0 - t) * a + t * b


def disney_diffuse_f(base, rough, wo, wi, flatness=None):
    """DisneyDiffuse and DisneyRetro (rough: the roughness); flatness (N,)
    blends the diffuse term toward the Hanrahan-Krueger fake subsurface
    term of the thin mode (DisneyFakeSS; 0: plain diffuse)."""
    wh = wi + wo
    wh_ok = (wh != 0.0).any(-1)
    cos_d = vm.absdot(wi, vm.normalize(wh))
    fl = _pow5(1.0 - abs_cos_theta(wi))
    fv = _pow5(1.0 - abs_cos_theta(wo))
    rr = 2.0 * rough * cos_d * cos_d
    diffuse = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    retro = rr * (fl + fv + fl * fv * (rr - 1.0))
    if flatness is not None:
        fss90 = cos_d * cos_d * rough
        fss = _lerp(fl, 1.0, fss90) * _lerp(fv, 1.0, fss90)
        denom = torch.clamp(abs_cos_theta(wi) + abs_cos_theta(wo), min=1e-6)
        ss = 1.25 * (fss * (1.0 / denom - 0.5) + 0.5)
        diffuse = _lerp(flatness, diffuse, ss)
    return base * (INV_PI * (diffuse + retro) * torch.where(wh_ok, 1.0, 0.0))[:, None]


def disney_gloss_f(f0, ax, ay, wo, wi):
    """The anisotropic TrowbridgeReitz lobe with Schlick's Fresnel toward f0
    (disney.rs microfacet and DisneyFresnel)."""
    wh = wi + wo
    wh_ok = (wh != 0.0).any(-1) & (abs_cos_theta(wi) > 0) & (abs_cos_theta(wo) > 0)
    wh_n = vm.normalize(wh)
    fr = f0 + _pow5(1.0 - vm.absdot(wi, wh_n))[:, None] * (1.0 - f0)
    denom = 4.0 * abs_cos_theta(wi) * abs_cos_theta(wo)
    return torch.where((wh_ok & (denom > 0))[:, None],
                       fr * (tr_d(wh_n, ax, ay) * tr_g(wo, wi, ax, ay)
                             / torch.clamp(denom, min=1e-12))[:, None], 0.0)


def _gtr1_d(alpha, cos2_wh):
    """The GTR1 distribution of clearcoat at alpha (disney.rs)."""
    a2 = torch.clamp(alpha * alpha, min=1e-6)
    return (a2 - 1.0) / (PI * torch.log(a2) * torch.clamp(1.0 + (a2 - 1.0) * cos2_wh, min=1e-12))


def disney_clearcoat_f(color, gloss, wo, wi):
    """DisneyClearcoat: GTR1 D at alpha gloss, Schlick's Fresnel at eta 1.5
    and Smith's G at alpha 0.25; color's x holds the weight."""
    wh = wi + wo
    wh_ok = (wh != 0.0).any(-1)
    wh_n = vm.normalize(wh)
    d = _gtr1_d(gloss, cos2_theta(wh_n))
    fr = 0.04 + _pow5(1.0 - vm.absdot(wi, wh_n)) * (1.0 - 0.04)
    quarter = torch.full_like(gloss, 0.25)
    g = 1.0 / (1.0 + tr_lambda(wo, quarter, quarter) + tr_lambda(wi, quarter, quarter))
    val = color[:, 0] * d * fr * g / 4.0
    return torch.where(wh_ok, val, 0.0)[:, None] * torch.ones_like(color)


# ---- materials to lobes ----

def check_supported(scene: sa.Scene):
    """Raises NotImplementedError for textured material parameters, which
    the port cannot shade yet; every material type is shaded."""
    if scene.tex_slot_mask:
        raise NotImplementedError("textured material parameters are not ported yet "
                                  "(ROADMAP queue A)")


_MAT_LOBES = {
    sa.MATTE: (LOBE_LAMBERT, LOBE_ORENNAYAR),
    sa.PLASTIC: (LOBE_LAMBERT, LOBE_MICROFACET_REFL),
    sa.MIRROR: (LOBE_SPEC_REFL,),
    sa.GLASS: (LOBE_FRESNEL_SPEC, LOBE_MICROFACET_REFL, LOBE_MICROFACET_TRANS),
    sa.SUBSURFACE: (LOBE_FRESNEL_SPEC, LOBE_MICROFACET_REFL, LOBE_MICROFACET_TRANS),
    sa.METAL: (LOBE_MICROFACET_REFL_COND,),
    sa.SUBSTRATE: (LOBE_FRESNEL_BLEND,),
    sa.UBER: (LOBE_LAMBERT, LOBE_MICROFACET_REFL, LOBE_SPEC_REFL_FR, LOBE_SPEC_TRANS,
              LOBE_SPEC_TRANS_PASS),
    sa.TRANSLUCENT: (LOBE_LAMBERT, LOBE_LAMBERT_TRANS, LOBE_MICROFACET_REFL,
                     LOBE_MICROFACET_TRANS),
    sa.DISNEY: (LOBE_DISNEY_DIFFUSE, LOBE_DISNEY_GLOSS, LOBE_DISNEY_CLEARCOAT, LOBE_DISNEY_SHEEN,
                LOBE_LAMBERT_TRANS, LOBE_MICROFACET_TRANS),
    sa.HAIR: (LOBE_HAIR,),
    sa.FOURIER: (LOBE_FOURIER,),
    # a mix's children may hold any lobe
    sa.MIXMAT: tuple(range(1, N_LOBE_KINDS)),
}


def lobe_mask_of(mat_mask: int) -> int:
    """The lobe tags a scene of the material types in mat_mask may hold, as
    a bitmask (the JAX lobe_mask_of; -1 for any)."""
    if mat_mask < 0:
        return -1
    lm = 0
    for mt, lobes in _MAT_LOBES.items():
        if mat_mask & (1 << mt):
            for lobe in lobes:
                lm |= 1 << lobe
    return lm if lm else -1


# the lobes each material puts in each slot (make_bsdf)
_SLOT_LOBES = {
    sa.MATTE: ((LOBE_LAMBERT, LOBE_ORENNAYAR),),
    sa.PLASTIC: ((LOBE_LAMBERT,), (LOBE_MICROFACET_REFL,)),
    sa.MIRROR: ((LOBE_SPEC_REFL,),),
    sa.GLASS: ((LOBE_FRESNEL_SPEC, LOBE_MICROFACET_REFL), (LOBE_MICROFACET_TRANS,)),
    sa.SUBSURFACE: ((LOBE_FRESNEL_SPEC, LOBE_MICROFACET_REFL), (LOBE_MICROFACET_TRANS,)),
    sa.METAL: ((LOBE_MICROFACET_REFL_COND,),),
    sa.SUBSTRATE: ((LOBE_FRESNEL_BLEND,),),
    sa.UBER: ((LOBE_LAMBERT,), (LOBE_MICROFACET_REFL,), (LOBE_SPEC_REFL_FR,), (LOBE_SPEC_TRANS,),
              (LOBE_SPEC_TRANS_PASS,)),
    sa.TRANSLUCENT: ((LOBE_LAMBERT,), (LOBE_LAMBERT_TRANS,), (LOBE_MICROFACET_REFL,),
                     (LOBE_MICROFACET_TRANS,)),
    sa.DISNEY: ((LOBE_DISNEY_DIFFUSE,), (LOBE_DISNEY_GLOSS,), (LOBE_DISNEY_CLEARCOAT,),
                (LOBE_MICROFACET_TRANS, LOBE_DISNEY_SHEEN), (LOBE_LAMBERT_TRANS,)),
    sa.HAIR: ((LOBE_HAIR,),),
    sa.FOURIER: ((LOBE_FOURIER,),),
}


def slot_lobe_masks(mat_mask: int) -> tuple:
    """Each of the six slots' lobe mask for the material types of mat_mask:
    the lobes its materials put there and, with mix materials, in slots 2
    and 3 the lobes any material puts in slots 0 and 1 (a mix's second
    material's).  The families a slot cannot hold need no math there."""
    masks = [0] * 6
    for mt, slots in _SLOT_LOBES.items():
        if mat_mask & (1 << mt):
            for si, lobes in enumerate(slots):
                for lobe in lobes:
                    masks[si] |= 1 << lobe
    if mat_mask & (1 << sa.MIXMAT):
        masks[2] |= masks[0]
        masks[3] |= masks[1]
    return tuple(masks)


def _has_lobe(b: Bsdf, k: int, mask: int = None) -> bool:
    """Whether lobe k may occur in b (in the slot of lobe mask `mask`)."""
    return bool((b.lobe_mask if mask is None else mask) & (1 << k))


def make_bsdf(mat_type, params, uv=None, enable_hair: bool = True,
              enable_glass: bool = True, enable_microfacet: bool = True,
              mat_mask: int = BASE_MATERIALS, fou=None) -> Bsdf:
    """Material tags (N,) and parameter rows (N, N_MAT_PARAMS) -> Bsdf
    (material.rs compute_scattering_functions, the JAX make_bsdf).  uv (N,
    2): the hits' coordinates, whose v gives a fibre's offset h (0 without
    uv).  mat_mask: the material types the lanes may hold (static; it
    decides the slots and the lobe masks).  enable_hair / enable_glass /
    enable_microfacet False: the scene has no hair / no smooth glass lobe
    / no microfacet lobe, which mat_mask alone does not say (a mix may
    hold any lobe, glass may be smooth): those bits leave the lobe masks
    and their math is skipped.  fou: the scene's FourierTable."""
    n = mat_type.shape[0]
    has = lambda t: bool(mat_mask & ((1 << t) | (1 << sa.MIXMAT)))
    kd = params[:, sa.MP_KD:sa.MP_KD + 3]
    kr = params[:, sa.MP_KR:sa.MP_KR + 3]
    kt = params[:, sa.MP_KT:sa.MP_KT + 3]
    # the later slices' materials read ks and the conductor's eta and k
    later = bool(mat_mask & ~BASE_MATERIALS)
    ks = params[:, sa.MP_KS:sa.MP_KS + 3] if later else None
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
    eta3 = params[:, sa.MP_ETA3:sa.MP_ETA3 + 3] if later else None
    k3 = params[:, sa.MP_K3:sa.MP_K3 + 3] if later else None
    # slots 2 and 3 where a material can need more than two lobes, 4 and 5
    # where one can need five (uber.rs:142-257: kd, ks, kr, kt and the
    # opacity's pass-through)
    need4 = has(sa.UBER) or has(sa.TRANSLUCENT) or has(sa.DISNEY)
    need6 = has(sa.UBER) or has(sa.DISNEY)
    kind2 = kind3 = kind4 = kind5 = r2 = r3 = r4 = r5 = None
    if need4:
        kind2, kind3, r2, r3 = kind0.clone(), kind0.clone(), r0.clone(), r0.clone()
    if need6:
        kind4, kind5, r4, r5 = kind0.clone(), kind0.clone(), r0.clone(), r0.clone()
    ax2 = ay2 = eta2 = sigma2 = None
    # matte (materials/matte.rs): Lambert, or Oren-Nayar for sigma > 0
    m = mat_type == sa.MATTE
    kind0 = torch.where(m & ~is_black(kd),
                        torch.where(sigma == 0.0, LOBE_LAMBERT, LOBE_ORENNAYAR).to(torch.int32),
                        kind0)
    r0 = torch.where(m[:, None], kd, r0)
    if has(sa.PLASTIC):
        # plastic (materials/plastic.rs): Lambert and a dielectric gloss
        m = mat_type == sa.PLASTIC
        kind0 = torch.where(m & ~is_black(kd), LOBE_LAMBERT, kind0)
        kind1 = torch.where(m & ~is_black(ks), LOBE_MICROFACET_REFL, kind1)
        r0 = torch.where(m[:, None], kd, r0)
        r1 = torch.where(m[:, None], ks, r1)
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
    if has(sa.METAL):
        # metal (materials/metal.rs): the conductor gloss
        m = mat_type == sa.METAL
        kind0 = torch.where(m, LOBE_MICROFACET_REFL_COND, kind0)
        r0 = torch.where(m[:, None], torch.ones_like(kr), r0)
    if has(sa.SUBSTRATE):
        # substrate (materials/substrate.rs): FresnelBlend of kd and ks
        m = mat_type == sa.SUBSTRATE
        kind0 = torch.where(m, LOBE_FRESNEL_BLEND, kind0)
        r0 = torch.where(m[:, None], kd, r0)
        r1 = torch.where(m[:, None], ks, r1)
    if has(sa.UBER):
        # uber (materials/uber.rs:142-257): Lambert, gloss, specular
        # reflection and transmission, each times the opacity, and the
        # pass-through SpecularTransmission(1 - opacity, 1, 1) in slot 4
        m = mat_type == sa.UBER
        op = params[:, sa.MP_OPACITY:sa.MP_OPACITY + 3]
        t_pass = 1.0 - op
        kd_u, ks_u, kr_u, kt_u = kd * op, ks * op, kr * op, kt * op
        kind0 = torch.where(m & ~is_black(kd_u), LOBE_LAMBERT, kind0)
        kind1 = torch.where(m & ~is_black(ks_u), LOBE_MICROFACET_REFL, kind1)
        r0 = torch.where(m[:, None], kd_u, r0)
        r1 = torch.where(m[:, None], ks_u, r1)
        kind2 = torch.where(m & ~is_black(kr_u), LOBE_SPEC_REFL_FR, kind2)
        r2 = torch.where(m[:, None], kr_u, r2)
        kind3 = torch.where(m & ~is_black(kt_u), LOBE_SPEC_TRANS, kind3)
        r3 = torch.where(m[:, None], kt_u, r3)
        kind4 = torch.where(m & ~is_black(t_pass), LOBE_SPEC_TRANS_PASS, kind4)
        r4 = torch.where(m[:, None], t_pass, r4)
    if has(sa.DISNEY):
        # Disney (materials/disney.rs:640): diffuse and retro, the tinted
        # anisotropic gloss, GTR1 clearcoat (slot 2), sheen or specular
        # transmission (slot 3; transmission wins), the thin mode's
        # Lambertian transmission (slot 4).  Packing (builder.add_disney):
        # MP_KS = (metallic, sheen, clearcoat), MP_OPACITY = (spec_tint,
        # anisotropic, spec_trans), MP_KR = (clearcoat_gloss, sheen_tint,
        # flatness), MP_KT = (thin, diff_trans, 0)
        m = mat_type == sa.DISNEY
        metallic, sheen_w, cc_w = ks[:, 0], ks[:, 1], ks[:, 2]
        spec_tint = params[:, sa.MP_OPACITY]
        aniso = params[:, sa.MP_OPACITY + 1]
        s_trans = params[:, sa.MP_OPACITY + 2]
        cc_gloss, sheen_tint = kr[:, 0], kr[:, 1]
        # the tint: the base's hue and saturation (disney.rs CalculateTint)
        lum = kd[:, 0] * 0.2126 + kd[:, 1] * 0.7152 + kd[:, 2] * 0.0722
        ctint = torch.where(lum[:, None] > 0, kd / torch.clamp(lum[:, None], min=1e-6), 1.0)
        white = torch.ones_like(kd)
        # DisneyFresnel's Cspec0: lerp(metallic, 0.04 lerp(spec_tint, 1, tint), base)
        spec0 = 0.04 * _lerp(spec_tint[:, None], white, ctint)
        f0 = _lerp(metallic[:, None], spec0, kd)
        kind0 = torch.where(m, LOBE_DISNEY_DIFFUSE, kind0)
        kind1 = torch.where(m, LOBE_DISNEY_GLOSS, kind1)
        # the thin mode: dt = diff_trans / 2 of the diffuse energy goes to a
        # Lambertian transmission lobe; flatness blends the diffuse lobe
        # toward the fake subsurface term; both ride k3
        thin = kt[:, 0] > 0.5
        dt = torch.where(thin, 0.5 * kt[:, 1], 0.0)
        flat = torch.where(thin, kr[:, 2], 0.0)
        k3 = torch.where(m[:, None], torch.stack([flat, dt, torch.zeros_like(dt)], -1), k3)
        diff_w = (1.0 - metallic) * (1.0 - s_trans)
        r0 = torch.where(m[:, None], kd * (diff_w * (1.0 - dt))[:, None], r0)
        r1 = torch.where(m[:, None], f0, r1)
        # alpha = roughness^2, split by the anisotropy's aspect
        aspect = torch.sqrt(torch.clamp(1.0 - 0.9 * aniso, min=1e-4))
        alpha = torch.clamp(rough_u * rough_u, min=1e-4)
        ax = torch.where(m, alpha / aspect, ax)
        ay = torch.where(m, alpha * aspect, ay)
        sigma = torch.where(m, rough_u, sigma)  # the retro term's roughness
        kind2 = torch.where(m & (cc_w > 0), LOBE_DISNEY_CLEARCOAT, kind2)
        r2 = torch.where(m[:, None], torch.stack([cc_w, cc_w * 0, cc_w * 0], -1), r2)
        sigma2 = torch.where(m, _lerp(cc_gloss, 0.1, 0.001), 1.0)  # clearcoat's alpha
        csheen = _lerp(sheen_tint[:, None], white, ctint)
        trans_col = torch.sqrt(torch.clamp(kd, min=0.0)) * ((1.0 - metallic) * s_trans)[:, None]
        use_trans = s_trans > 0
        kind3 = torch.where(m & use_trans, LOBE_MICROFACET_TRANS,
                            torch.where(m & (sheen_w > 0), LOBE_DISNEY_SHEEN, kind3))
        r3 = torch.where(m[:, None], torch.where(use_trans[:, None], trans_col,
                                                 sheen_w[:, None] * diff_w[:, None] * csheen), r3)
        # the transmission shares the gloss's alphas
        ax2, ay2 = ax, ay
        eta_p = torch.where(params[:, sa.MP_ETA] > 0.0, params[:, sa.MP_ETA], 1.0)
        eta2 = torch.where(m, eta_p, 1.5)
        kind4 = torch.where(m & (dt > 0), LOBE_LAMBERT_TRANS, kind4)
        r4 = torch.where(m[:, None], kd * (diff_w * dt)[:, None], r4)
    if has(sa.TRANSLUCENT):
        # translucent (materials/translucent.rs:82-185): Lambertian
        # reflection and transmission of kd, microfacet reflection and
        # transmission of ks, times reflect (KR) and transmit (KT), at eta 1.5
        m = mat_type == sa.TRANSLUCENT
        kind0 = torch.where(m & ~is_black(kd * kr), LOBE_LAMBERT, kind0)
        kind1 = torch.where(m & ~is_black(kd * kt), LOBE_LAMBERT_TRANS, kind1)
        r0 = torch.where(m[:, None], kd * kr, r0)
        r1 = torch.where(m[:, None], kd * kt, r1)
        kind2 = torch.where(m & ~is_black(ks * kr), LOBE_MICROFACET_REFL, kind2)
        kind3 = torch.where(m & ~is_black(ks * kt), LOBE_MICROFACET_TRANS, kind3)
        r2 = torch.where(m[:, None], ks * kr, r2)
        r3 = torch.where(m[:, None], ks * kt, r3)
    if mat_mask & (1 << sa.FOURIER):
        # Fourier (materials/fourier.rs): the tabulated lobe, where the scene
        # has a table
        m = mat_type == sa.FOURIER
        if fou is not None:
            kind0 = torch.where(m, LOBE_FOURIER, kind0)
        kind1 = torch.where(m, LOBE_NONE, kind1)
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
    for t in (sa.PLASTIC, sa.TRANSLUCENT):
        if has(t):
            eta = torch.where(mat_type == t, 1.5, eta)
    h = (torch.zeros_like(sigma) if uv is None
         else torch.clamp(-1.0 + 2.0 * uv[:, 1], -1.0, 1.0))
    off = (0 if enable_hair else 1 << LOBE_HAIR) | (0 if enable_glass else 1 << LOBE_FRESNEL_SPEC)
    if not (enable_microfacet and (enable_glass or mat_mask & MICROFACET_MATERIALS)):
        off |= (1 << LOBE_MICROFACET_REFL) | (1 << LOBE_MICROFACET_TRANS)
    return Bsdf(kind0, kind1, r0, r1, sigma, ax, ay, eta, h, kt, eta3, k3, kind2, kind3, kind4,
                kind5, r2, r3, r4, r5, ax2, ay2, eta2, sigma2, lobe_mask_of(mat_mask) & ~off,
                tuple(m & ~off for m in slot_lobe_masks(mat_mask)), fou)


def _mix(scene: sa.Scene, mat_type, params, mat, uv, flags) -> Bsdf:
    """The Bsdf of a scene with mix materials (materials/mixmat.rs, the
    JAX make_bsdf_from_mat): a mix lane's first material's slots 0 and 1
    scaled by amount, its second material's slots 0 and 1 in slots 2 and 3
    scaled by 1 - amount, with the second's alphas, eta and sigma in the
    slot-2/3 parameters."""
    is_mix = mat_type == sa.MIXMAT
    amt = params[:, sa.MP_KD:sa.MP_KD + 3]
    aid = torch.round(params[:, sa.MP_KS]).long()
    bid = torch.round(params[:, sa.MP_KS + 1]).long()
    mat = mat.long()
    ma_a = scene.mat_attr[torch.where(is_mix, aid, mat)]
    ma_b = scene.mat_attr[torch.where(is_mix, bid, mat)]
    t_a = torch.where(is_mix, torch.round(ma_a[:, sa.MA_TYPE]).to(torch.int32), mat_type)
    p_a = torch.where(is_mix[:, None], ma_a[:, sa.MA_PARAMS:sa.MA_PARAMS + sa.N_MAT_PARAMS],
                      params)
    t_b = torch.round(ma_b[:, sa.MA_TYPE]).to(torch.int32)
    p_b = ma_b[:, sa.MA_PARAMS:sa.MA_PARAMS + sa.N_MAT_PARAMS]
    ba, bb = make_bsdf(t_a, p_a, uv, **flags), make_bsdf(t_b, p_b, uv, **flags)
    mix1 = is_mix[:, None]
    one_m = 1.0 - amt
    pick = lambda cur, other: torch.where(is_mix, other, cur)
    return ba._replace(
        r0=torch.where(mix1, ba.r0 * amt, ba.r0), r1=torch.where(mix1, ba.r1 * amt, ba.r1),
        kind2=pick(ba.kind2, bb.kind0), kind3=pick(ba.kind3, bb.kind1),
        r2=torch.where(mix1, bb.r0 * one_m, ba.r2), r3=torch.where(mix1, bb.r1 * one_m, ba.r3),
        ax2=pick(ba.ax2, bb.ax), ay2=pick(ba.ay2, bb.ay), eta2=pick(ba.eta2, bb.eta),
        sigma2=pick(ba.sigma2, bb.sigma))


def make_bsdf_from_mat(scene: sa.Scene, mat, uv=None) -> Bsdf:
    """The Bsdf of material ids mat (N,) (and, in a scene with hair, of the
    hits' uv; without uv a fibre's offset is 0, as the JAX package's
    make_bsdf_from_mat gives SPPM's visible points)."""
    check_supported(scene)
    ma = scene.mat_attr[mat.long()]
    mat_type = torch.round(ma[:, sa.MA_TYPE]).to(torch.int32)
    params = ma[:, sa.MA_PARAMS:sa.MA_PARAMS + sa.N_MAT_PARAMS]
    mask = scene.mat_kind_mask
    flags = dict(
        enable_hair=scene.has_hair,
        enable_glass=bool(mask & ((1 << sa.GLASS) | (1 << sa.SUBSURFACE) | (1 << sa.MIXMAT))),
        enable_microfacet=scene.has_rough_glass or bool(mask & MICROFACET_MATERIALS),
        mat_mask=mask, fou=table_of(scene))
    uv = uv if scene.has_hair else None
    if mask & (1 << sa.MIXMAT):
        return _mix(scene, mat_type, params, mat, uv, flags)
    return make_bsdf(mat_type, params, uv, **flags)


def make_bsdf_at(scene: sa.Scene, it) -> Bsdf:
    """The Bsdf at each hit of an Interaction, from its material id (and,
    in a scene with hair, its uv)."""
    return make_bsdf_from_mat(scene, it.mat, it.uv if scene.has_hair else None)


def _slots(b: Bsdf):
    """(kind, color, slot23) of the present lobe slots: 2, 4 or 6."""
    s = [(b.kind0, b.r0, False), (b.kind1, b.r1, False)]
    if b.kind2 is not None:
        s += [(b.kind2, b.r2, True), (b.kind3, b.r3, True)]
    if b.kind4 is not None:
        s += [(b.kind4, b.r4, False), (b.kind5, b.r5, False)]
    return s


def num_components(b: Bsdf):
    n = (b.kind0 != LOBE_NONE).to(torch.int32) + (b.kind1 != LOBE_NONE).to(torch.int32)
    for kind, _, _ in _slots(b)[2:]:
        n = n + (kind != LOBE_NONE).to(torch.int32)
    return n


def has_nonspecular(b: Bsdf):
    """Any non-specular lobe in any slot (Bsdf::num_components without
    BSDF_SPECULAR)."""
    spec = [k for k in SPECULAR_LOBES[2:] if _has_lobe(b, k)]

    def non(k):
        out = (k != LOBE_NONE) & (k != LOBE_SPEC_REFL) & (k != LOBE_FRESNEL_SPEC)
        for sk in spec:
            out = out & (k != sk)
        return out
    out = None
    for kind, _, _ in _slots(b):
        out = non(kind) if out is None else out | non(kind)
    return out


def _slot_params(b: Bsdf, slot23: bool):
    """(ax, ay, eta, sigma) of a lobe slot: slots 2 and 3 read their own
    where the Bsdf has them (Disney, mix)."""
    if slot23 and b.ax2 is not None:
        return b.ax2, b.ay2, b.eta2, b.sigma2
    return b.ax, b.ay, b.eta, b.sigma


def _dist(b: Bsdf):
    """The microfacet distribution's D, G, sample_wh and pdf_wh
    (microfacet.rs:22): Beckmann where the Bsdf asks, else TrowbridgeReitz."""
    if b.use_beckmann:
        return bk_d, bk_g, bk_sample_wh, bk_pdf_wh
    return tr_d, tr_g, tr_sample_wh, tr_pdf_wh


def _lobe_f(kind, color, b: Bsdf, wo, wi, reflect, slot23: bool = False, mask: int = None):
    """One lobe slot's f for all lanes (specular lobes give 0; the hair and
    Fourier lobes are bsdf_f's); mask: the slot's lobe mask (b.lobe_mask
    where None)."""
    hasl = lambda k: _has_lobe(b, k, mask)
    ax, ay, eta, sigma = _slot_params(b, slot23)
    d_fn, g_fn, _, _ = _dist(b)
    out = torch.where((kind == LOBE_LAMBERT)[:, None], color * INV_PI, 0.0)
    out = torch.where((kind == LOBE_ORENNAYAR)[:, None], oren_nayar_f(color, sigma, wo, wi), out)
    mf_refl = hasl(LOBE_MICROFACET_REFL)
    cond, blend = hasl(LOBE_MICROFACET_REFL_COND), hasl(LOBE_FRESNEL_BLEND)
    if mf_refl or cond or blend:
        # MicrofacetReflection::f, the Fresnel term at wh facing forward
        wh = wi + wo
        wh_ok = (wh != 0.0).any(-1) & (abs_cos_theta(wi) > 0) & (abs_cos_theta(wo) > 0)
        wh_n = vm.normalize(wh)
        wh_f = wh_n * torch.sign(wh_n[..., 2:3])
        d_val = d_fn(wh_n, ax, ay)
    if mf_refl or cond:
        denom = 4.0 * abs_cos_theta(wi) * abs_cos_theta(wo)
        f_mf = torch.where((wh_ok & (denom > 0))[:, None],
                           color * (d_val * g_fn(wo, wi, ax, ay)
                                    / torch.clamp(denom, min=1e-12))[:, None], 0.0)
        if mf_refl:
            fr = fr_dielectric(vm.dot(wi, wh_f), torch.ones_like(eta), eta)
            out = torch.where((kind == LOBE_MICROFACET_REFL)[:, None], f_mf * fr[:, None], out)
        if cond:
            fr_c = fr_conductor(vm.dot(wi, wh_f), torch.ones_like(b.eta3), b.eta3, b.k3)
            out = torch.where((kind == LOBE_MICROFACET_REFL_COND)[:, None], f_mf * fr_c, out)
    if blend:
        # FresnelBlend (reflection.rs): the substrate's diffuse and glossy terms
        diffuse = (FRESNEL_BLEND_K * b.r0 * (1.0 - b.r1)
                   * (1.0 - _pow5(1.0 - 0.5 * abs_cos_theta(wi)))[:, None]
                   * (1.0 - _pow5(1.0 - 0.5 * abs_cos_theta(wo)))[:, None])
        schlick = b.r1 + _pow5(1.0 - vm.absdot(wi, wh_f))[:, None] * (1.0 - b.r1)
        spec = torch.where(wh_ok[:, None], (d_val / torch.clamp(
            4.0 * vm.absdot(wi, wh_n) * torch.maximum(abs_cos_theta(wi), abs_cos_theta(wo)),
            min=1e-12))[:, None] * schlick, 0.0)
        out = torch.where((kind == LOBE_FRESNEL_BLEND)[:, None], diffuse + spec, out)
    if hasl(LOBE_DISNEY_DIFFUSE):
        out = torch.where((kind == LOBE_DISNEY_DIFFUSE)[:, None],
                          disney_diffuse_f(color, sigma, wo, wi, flatness=b.k3[:, 0]), out)
    if hasl(LOBE_DISNEY_GLOSS):
        out = torch.where((kind == LOBE_DISNEY_GLOSS)[:, None],
                          disney_gloss_f(color, ax, ay, wo, wi), out)
    if hasl(LOBE_DISNEY_CLEARCOAT):
        out = torch.where((kind == LOBE_DISNEY_CLEARCOAT)[:, None],
                          disney_clearcoat_f(color, sigma, wo, wi), out)
    if hasl(LOBE_DISNEY_SHEEN):
        # DisneySheen::f: R times Schlick's weight of |wi . wh|
        wh_s = wi + wo
        cos_d = vm.absdot(wi, vm.normalize(wh_s))
        out = torch.where((kind == LOBE_DISNEY_SHEEN)[:, None],
                          color * (_pow5(1.0 - cos_d)
                                   * torch.where((wh_s != 0.0).any(-1), 1.0, 0.0))[:, None], out)
    # reflective lobes contribute only on the reflecting side, with wo and wi
    # in the same shading hemisphere
    out = torch.where((reflect & same_hemisphere(wo, wi))[:, None], out, 0.0)
    if hasl(LOBE_LAMBERT_TRANS):
        # LambertianTransmission: the opposite hemisphere
        out = torch.where((kind == LOBE_LAMBERT_TRANS)[:, None],
                          torch.where((~same_hemisphere(wo, wi) & ~reflect)[:, None],
                                      color * INV_PI, 0.0), out)
    if hasl(LOBE_MICROFACET_TRANS):
        ft = _microfacet_trans_f(color, wo, wi, ax, ay, eta, d_fn, g_fn)
        out = torch.where((kind == LOBE_MICROFACET_TRANS)[:, None],
                          torch.where((~same_hemisphere(wo, wi) & ~reflect)[:, None], ft, 0.0),
                          out)
    return out


def _lobe_pdf(kind, b: Bsdf, wo, wi, slot23: bool = False, mask: int = None):
    hasl = lambda k: _has_lobe(b, k, mask)
    ax, ay, eta, sigma = _slot_params(b, slot23)
    _, _, _, pdf_wh = _dist(b)
    pdf_cos = abs_cos_theta(wi) * INV_PI
    cos_kinds = (kind == LOBE_LAMBERT) | (kind == LOBE_ORENNAYAR)
    for k in (LOBE_DISNEY_DIFFUSE, LOBE_DISNEY_SHEEN):
        if hasl(k):
            cos_kinds = cos_kinds | (kind == k)
    out = torch.where(cos_kinds, pdf_cos, 0.0)
    mf_refl = hasl(LOBE_MICROFACET_REFL)
    glossy = [k for k in (LOBE_MICROFACET_REFL_COND, LOBE_DISNEY_GLOSS) if hasl(k)]
    if mf_refl or glossy or hasl(LOBE_FRESNEL_BLEND) or hasl(LOBE_DISNEY_CLEARCOAT):
        wh = vm.normalize(wi + wo)
        pdf_mf = pdf_wh(wo, wh, ax, ay) / torch.clamp(4.0 * vm.dot(wo, wh), min=1e-12)
        mf_kinds = kind == LOBE_MICROFACET_REFL
        for k in glossy:
            mf_kinds = mf_kinds | (kind == k)
        out = torch.where(mf_kinds, pdf_mf, out)
        if hasl(LOBE_FRESNEL_BLEND):
            out = torch.where(kind == LOBE_FRESNEL_BLEND, 0.5 * (pdf_cos + pdf_mf), out)
        if hasl(LOBE_DISNEY_CLEARCOAT):
            # clearcoat samples the whole GTR1 distribution: D |cos wh| / (4 wo.wh)
            d_cc = _gtr1_d(sigma, cos2_theta(wh))
            out = torch.where(kind == LOBE_DISNEY_CLEARCOAT,
                              d_cc * abs_cos_theta(wh) / torch.clamp(4.0 * vm.dot(wo, wh),
                                                                     min=1e-12), out)
    out = torch.where(same_hemisphere(wo, wi), out, 0.0)
    if hasl(LOBE_LAMBERT_TRANS):
        out = torch.where(kind == LOBE_LAMBERT_TRANS,
                          torch.where(same_hemisphere(wo, wi), 0.0, pdf_cos), out)
    if hasl(LOBE_MICROFACET_TRANS):
        out = torch.where(kind == LOBE_MICROFACET_TRANS,
                          _microfacet_trans_pdf(wo, wi, ax, ay, eta, pdf_wh), out)
    return out


def fourier_terms(b: Bsdf, wo, wi):
    """(f (N, 3), pdf (N,)) of the Fourier lobe at (wo, wi) on the lanes
    whose slot 0 or 2 holds it (F1), or None where the Bsdf has none."""
    if b.fou is None or not _has_lobe(b, LOBE_FOURIER):
        return None
    on = b.kind0 == LOBE_FOURIER
    if b.kind2 is not None and _has_lobe(b, LOBE_FOURIER, _slot_mask(b, 2)):
        on = on | (b.kind2 == LOBE_FOURIER)
    return fourier_kernel.fourier_eval(b.fou, wo, wi, on)


def _slot_mask(b: Bsdf, i: int):
    return None if b.slot_masks is None else b.slot_masks[i]


def bsdf_f(b: Bsdf, wo, wi, reflect, fou=None):
    """f summed over the non-specular lobes (reflection.rs:355 Bsdf::f); the
    hair and Fourier lobes over the whole sphere.  fou: fourier_terms at
    (wo, wi) where the caller has them (bsdf_pdf at the same directions
    takes the same)."""
    if fou is None:
        fou = fourier_terms(b, wo, wi)
    hair = hair_f(b, wo, wi) if _has_lobe(b, LOBE_HAIR) else None
    out = None
    for i, (kind, color, s23) in enumerate(_slots(b)):
        mask = _slot_mask(b, i)
        v = _lobe_f(kind, color, b, wo, wi, reflect, s23, mask)
        if hair is not None and _has_lobe(b, LOBE_HAIR, mask):
            v = torch.where((kind == LOBE_HAIR)[:, None], hair, v)
        if fou is not None and _has_lobe(b, LOBE_FOURIER, mask):
            v = torch.where((kind == LOBE_FOURIER)[:, None], fou[0], v)
        out = v if out is None else out + v
    return out


def bsdf_pdf(b: Bsdf, wo, wi, fou=None):
    """The pdf averaged over the components (Bsdf::pdf).  fou: as in
    bsdf_f."""
    if fou is None:
        fou = fourier_terms(b, wo, wi)
    hair = hair_pdf(b, wo, wi) if _has_lobe(b, LOBE_HAIR) else None
    p = None
    for i, (kind, _, s23) in enumerate(_slots(b)):
        mask = _slot_mask(b, i)
        v = _lobe_pdf(kind, b, wo, wi, s23, mask)
        if hair is not None and _has_lobe(b, LOBE_HAIR, mask):
            v = torch.where(kind == LOBE_HAIR, hair, v)
        if fou is not None and _has_lobe(b, LOBE_FOURIER, mask):
            v = torch.where(kind == LOBE_FOURIER, fou[1], v)
        p = v if p is None else p + v
    n = num_components(b)
    return torch.where(n > 0, p / torch.clamp(n.to(torch.float32), min=1.0), 0.0)


def _pick_slot(b: Bsdf, uc, n_comp):
    """The lobe slot uc picks among the present ones (reflection.rs:287-300):
    (kind, color, sel23, the slot's ax, ay, eta).  Two slots take the JAX
    package's two-slot pick (bsdf.py:1498): slot 1 where uc n >= 1, even
    on a lane whose slot 0 is empty; more take the ci-th present slot."""
    slots = _slots(b)
    if len(slots) == 2:
        pick1 = (uc * torch.clamp(n_comp, min=1.0)) >= 1.0
        kind = torch.where(pick1, b.kind1, b.kind0)
        color = torch.where(pick1[:, None], b.r1, b.r0)
        return kind, color, None, b.ax, b.ay, b.eta
    # the ci-th present slot by rank
    pres = [k != LOBE_NONE for k, _, _ in slots]
    n_int = num_components(b)
    ci = torch.floor(uc * torch.clamp(n_comp, min=1.0)).to(torch.int32)
    ci = torch.minimum(ci, torch.clamp(n_int - 1, min=0))
    rank = torch.cumsum(torch.stack([p.to(torch.int32) for p in pres], 0), 0) - 1
    kind = torch.full_like(b.kind0, LOBE_NONE)
    color = torch.zeros_like(b.r0)
    sel23 = torch.zeros_like(pres[0])
    for si, (k, c, s23) in enumerate(slots):
        hit = pres[si] & (rank[si] == ci)
        kind = torch.where(hit, k, kind)
        color = torch.where(hit[:, None], c, color)
        if s23:
            sel23 = sel23 | hit
    if b.ax2 is None:
        return kind, color, sel23, b.ax, b.ay, b.eta
    return (kind, color, sel23, torch.where(sel23, b.ax2, b.ax), torch.where(sel23, b.ay2, b.ay),
            torch.where(sel23, b.eta2, b.eta))


def bsdf_sample(b: Bsdf, wo, u2, uc) -> BsdfSample:
    """Importance-sample the BSDF (reflection.rs:280 Bsdf::sample_f): uc
    picks a present lobe slot, u2 samples it (cosine hemisphere, the mirror
    direction, a microfacet normal to reflect or refract through, Fresnel's
    choice of smooth glass's reflection or refraction by u2.x, GTR1's
    normal, FresnelBlend's half and half, the hair lobe, or the Fourier
    lobe's F2); f and pdf combine the non-specular lobes.  A family the
    Bsdf cannot hold costs no op."""
    hasl = lambda k: _has_lobe(b, k)
    n_comp = num_components(b).to(torch.float32)
    kind, color, sel23, ax_s, ay_s, eta_s = _pick_slot(b, uc, n_comp)
    _, _, sample_wh, _ = _dist(b)
    # the delta and transmitting lobes' lanes, of those the Bsdf may hold
    sel = {k: kind == k for k in (LOBE_LAMBERT_TRANS, LOBE_SPEC_REFL_FR, LOBE_SPEC_TRANS,
                                  LOBE_SPEC_TRANS_PASS) if hasl(k)}
    wi = cosine_sample_hemisphere(u2)
    sign_o = torch.sign(torch.where(cos_theta(wo) == 0, 1.0, cos_theta(wo)))[:, None]
    wi = wi_cos = wi * sign_o
    if LOBE_LAMBERT_TRANS in sel:
        wi = torch.where(sel[LOBE_LAMBERT_TRANS][:, None], -wi_cos, wi)
    is_spec_r = kind == LOBE_SPEC_REFL
    wi_spec = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    is_mf = kind == LOBE_MICROFACET_REFL
    for k in (LOBE_MICROFACET_REFL_COND, LOBE_DISNEY_GLOSS):
        if hasl(k):
            is_mf = is_mf | (kind == k)
    is_mft = kind == LOBE_MICROFACET_TRANS
    is_fs = kind == LOBE_FRESNEL_SPEC
    entering = cos_theta(wo) > 0.0
    fr = fr_dielectric(cos_theta(wo), torch.ones_like(eta_s), eta_s)
    choose_refl = u2[:, 0] < fr
    ok_t = mft_ok = st_ok = torch.ones_like(entering)
    if any(hasl(k) for k in (LOBE_MICROFACET_REFL, LOBE_MICROFACET_REFL_COND, LOBE_DISNEY_GLOSS,
                             LOBE_MICROFACET_TRANS)):
        # glossy reflection and transmission through a sampled wh
        # (MicrofacetTransmission::sample_f, reflection.rs:1316-1346)
        wh = sample_wh(wo, u2, ax_s, ay_s)
        wi = torch.where(is_mf[:, None], reflect_dir(wo, wh), wi)
        if hasl(LOBE_MICROFACET_TRANS):
            wh_side = wh * torch.sign(vm.dot(wo, wh))[:, None]
            ok_rt, wi_rt = refract_dir(wo, wh_side, torch.where(entering, 1.0 / eta_s, eta_s))
            wi = torch.where(is_mft[:, None], wi_rt, wi)
            mft_ok = torch.where(is_mft, ok_rt, mft_ok)
    if hasl(LOBE_DISNEY_CLEARCOAT):
        # GTR1's normal (disney.rs DisneyClearcoat::sample_f)
        gloss = b.sigma if b.sigma2 is None else torch.where(sel23, b.sigma2, b.sigma)
        a2 = torch.clamp(gloss * gloss, min=1e-6)
        ct2 = (1.0 - torch.pow(a2, 1.0 - u2[:, 0])) / torch.clamp(1.0 - a2, min=1e-9)
        ct = torch.sqrt(torch.clamp(ct2, 0.0, 1.0))
        st = torch.sqrt(torch.clamp(1.0 - ct2, min=0.0))
        phi = 2.0 * PI * u2[:, 1]
        wh_cc = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
        wh_cc = torch.where(same_hemisphere(wo, wh_cc)[:, None], wh_cc, -wh_cc)
        wi = torch.where((kind == LOBE_DISNEY_CLEARCOAT)[:, None], reflect_dir(wo, wh_cc), wi)
    if LOBE_SPEC_REFL_FR in sel:
        wi = torch.where(sel[LOBE_SPEC_REFL_FR][:, None], wi_spec, wi)
    wi = torch.where(is_spec_r[:, None], wi_spec, wi)
    glass = hasl(LOBE_FRESNEL_SPEC)
    if LOBE_SPEC_TRANS in sel or glass:
        n_up = torch.tensor([0.0, 0.0, 1.0], device=wo.device).expand_as(wo)
    if LOBE_SPEC_TRANS in sel:
        # uber's kt (SpecularTransmission::sample_f at the lane's eta)
        is_st = sel[LOBE_SPEC_TRANS]
        ok_st, wi_st = refract_dir(wo, torch.where(entering[:, None], n_up, -n_up),
                                   torch.where(entering, 1.0 / eta_s, eta_s))
        wi = torch.where(is_st[:, None], wi_st, wi)
        st_ok = torch.where(is_st, ok_st, st_ok)
    if LOBE_SPEC_TRANS_PASS in sel:
        wi = torch.where(sel[LOBE_SPEC_TRANS_PASS][:, None], -wo, wi)
    if glass:
        # smooth glass: reflect with Fresnel's probability, else refract
        # (FresnelSpecular::sample_f)
        ok_t, wi_t = refract_dir(wo, torch.where(entering[:, None], n_up, -n_up),
                                 torch.where(entering, 1.0 / eta_s, eta_s))
        wi = torch.where(is_fs[:, None], torch.where(choose_refl[:, None], wi_spec, wi_t), wi)
    if hasl(LOBE_FRESNEL_BLEND):
        # half the cosine hemisphere, half a reflection through wh
        # (FresnelBlend::sample_f)
        fb_spec = u2[:, 0] >= 0.5
        u_fb = torch.stack([torch.where(fb_spec, 2.0 * (u2[:, 0] - 0.5), 2.0 * u2[:, 0]),
                            u2[:, 1]], -1)
        wi_fb = torch.where(fb_spec[:, None], reflect_dir(wo, sample_wh(wo, u_fb, ax_s, ay_s)),
                            cosine_sample_hemisphere(u_fb) * sign_o)
        wi = torch.where((kind == LOBE_FRESNEL_BLEND)[:, None], wi_fb, wi)
    if hasl(LOBE_HAIR):
        wi = torch.where((kind == LOBE_HAIR)[:, None], hair_sample(b, wo, u2)[0], wi)
    if b.fou is not None and hasl(LOBE_FOURIER):
        is_fou = kind == LOBE_FOURIER
        wi = torch.where(is_fou[:, None], fourier_kernel.fourier_sample(b.fou, wo, u2, is_fou), wi)
    wi = vm.normalize(wi)
    is_specular = is_spec_r | is_fs
    for k in (LOBE_SPEC_REFL_FR, LOBE_SPEC_TRANS, LOBE_SPEC_TRANS_PASS):
        if k in sel:
            is_specular = is_specular | sel[k]
    # delta lobes: the pdf of the discrete choice (Fresnel's for smooth
    # glass) over the components
    fou = fourier_terms(b, wo, wi)
    pdf_delta = torch.where(is_fs, torch.where(choose_refl, fr, 1.0 - fr), 1.0)
    pdf = torch.where(is_specular, pdf_delta / torch.clamp(n_comp, min=1.0),
                      bsdf_pdf(b, wo, wi, fou))
    f = bsdf_f(b, wo, wi, same_hemisphere(wo, wi), fou)
    # the mirror's f = R / |cos wi|, the delta absorbed
    aci = torch.clamp(abs_cos_theta(wi), min=1e-7)
    f = torch.where(is_spec_r[:, None], color / aci[:, None], f)
    if LOBE_SPEC_REFL_FR in sel:
        f = torch.where(sel[LOBE_SPEC_REFL_FR][:, None], (fr / aci)[:, None] * color, f)
    if LOBE_SPEC_TRANS in sel:
        scale_st = torch.where(entering, 1.0 / (eta_s * eta_s), eta_s * eta_s)
        f_st = ((1.0 - fr) * scale_st / aci)[:, None] * color
        f = torch.where(is_st[:, None], torch.where((is_st & ~st_ok)[:, None], 0.0, f_st), f)
    if LOBE_SPEC_TRANS_PASS in sel:
        f = torch.where(sel[LOBE_SPEC_TRANS_PASS][:, None], color / aci[:, None], f)
    if glass:
        # radiance transport scales refraction by (eta_i / eta_t)^2
        scale_t = torch.where(entering, 1.0 / (eta_s * eta_s), eta_s * eta_s)
        f_fs = torch.where(choose_refl[:, None], (fr / aci)[:, None] * b.r0,
                           ((1.0 - fr) * scale_t / aci)[:, None] * b.kt)
        f_fs = torch.where((is_fs & ~choose_refl & ~ok_t)[:, None], 0.0, f_fs)
        f = torch.where(is_fs[:, None], f_fs, f)
    # a microfacet sample below the horizon, or a failed refraction: no sample
    bad = (is_mf & ~same_hemisphere(wo, wi)) | (is_mft & (same_hemisphere(wo, wi) | ~mft_ok))
    if LOBE_SPEC_TRANS in sel:
        bad = bad | (is_st & ~st_ok)
    none = (num_components(b) == 0) | bad
    pdf = torch.where(none, 0.0, pdf)
    f = torch.where(none[:, None], 0.0, f)
    is_transmission = (is_fs & ~choose_refl) | is_mft
    for k in (LOBE_LAMBERT_TRANS, LOBE_SPEC_TRANS, LOBE_SPEC_TRANS_PASS):
        if k in sel:
            is_transmission = is_transmission | sel[k]
    return BsdfSample(wi, f, pdf, is_specular, is_transmission)
