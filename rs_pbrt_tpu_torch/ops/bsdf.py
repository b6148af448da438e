"""The BSDF of matte and mirror materials as batched tag-switched code.

The port of the JAX package's ``ops/bsdf.py`` for the lobes of the matte
and mirror materials (reference src/core/reflection.rs, materials/matte.rs
and mirror.rs): Lambert, Oren-Nayar (matte with sigma > 0) and perfect
specular reflection.  Every lane carries up to two lobe slots of the JAX
package's Bsdf; each lobe family is evaluated for all lanes and selected
by its tag.  Other materials and textured parameters raise
NotImplementedError (``check_supported``).

Convention: the shading-local frame has z = the shading normal; wo and wi
are unit vectors in it.  Reflection against transmission is decided on
the geometric normal by the caller (the ``reflect`` flag).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene import arrays as sa
from ..utils import vecmath as vm
from .sampling import cosine_sample_hemisphere

INV_PI = float(vm.INV_PI)

# lobe tags, numbered as in the JAX package (the other 15 come with their
# materials)
LOBE_NONE = 0
LOBE_LAMBERT = 1
LOBE_ORENNAYAR = 2
LOBE_SPEC_REFL = 3
PORTED_MATERIALS = (1 << sa.MATTE) | (1 << sa.MIRROR)


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


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def oren_nayar_f(r, sigma_deg, wo, wi):
    """Oren-Nayar f (reflection.rs OrenNayar); r (N,3), sigma in degrees."""
    sigma = torch.deg2rad(sigma_deg)
    sigma2 = sigma * sigma
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    sin_ti = torch.sqrt(torch.clamp(sin2_theta(wi), min=1e-24))
    sin_to = torch.sqrt(torch.clamp(sin2_theta(wo), min=1e-24))
    cos_diff = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo)
    max_cos = torch.where((sin_ti > 1e-4) & (sin_to > 1e-4), torch.clamp(cos_diff, min=0.0), 0.0)
    aci, aco = abs_cos_theta(wi), abs_cos_theta(wo)
    sin_a = torch.where(aci > aco, sin_to, sin_ti)
    tan_b = torch.where(aci > aco, sin_ti / torch.clamp(aci, min=1e-7),
                        sin_to / torch.clamp(aco, min=1e-7))
    return r * (INV_PI * (a + b * max_cos * sin_a * tan_b))[..., None]


class Bsdf(NamedTuple):
    """Two lobe slots per lane (the JAX package's slots 0 and 1)."""

    kind0: torch.Tensor  # (N,) lobe tags
    kind1: torch.Tensor
    r0: torch.Tensor  # (N,3) lobe colors (kd, kr)
    r1: torch.Tensor
    sigma: torch.Tensor  # (N,) Oren-Nayar sigma, degrees


class BsdfSample(NamedTuple):
    wi: torch.Tensor  # (N,3) local
    f: torch.Tensor  # (N,3)
    pdf: torch.Tensor  # (N,)
    is_specular: torch.Tensor  # (N,) bool
    is_transmission: torch.Tensor  # (N,) bool


def check_supported(scene: sa.Scene):
    """Raises NotImplementedError for materials the port cannot shade yet."""
    if scene.mat_kind_mask & ~PORTED_MATERIALS:
        raise NotImplementedError("only the matte and mirror materials are ported so far "
                                  "(ROADMAP queue A)")
    if scene.tex_slot_mask:
        raise NotImplementedError("textured material parameters are not ported yet "
                                  "(ROADMAP queue A)")


def make_bsdf(mat_type, params) -> Bsdf:
    """Material tags (N,) and parameter rows (N, N_MAT_PARAMS) -> Bsdf
    (material.rs compute_scattering_functions for matte and mirror)."""
    n = mat_type.shape[0]
    kd = params[:, sa.MP_KD:sa.MP_KD + 3]
    kr = params[:, sa.MP_KR:sa.MP_KR + 3]
    sigma = params[:, sa.MP_SIGMA]
    is_black = lambda c: (c == 0.0).all(-1)
    kind0 = torch.full((n,), LOBE_NONE, dtype=torch.int32, device=params.device)
    r0 = torch.zeros((n, 3), dtype=torch.float32, device=params.device)
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
    return Bsdf(kind0, torch.full_like(kind0, LOBE_NONE), r0, torch.zeros_like(r0), sigma)


def make_bsdf_at(scene: sa.Scene, it) -> Bsdf:
    """The Bsdf at each hit of an Interaction, from its material id."""
    check_supported(scene)
    ma = scene.mat_attr[it.mat.long()]
    return make_bsdf(torch.round(ma[:, sa.MA_TYPE]).to(torch.int32),
                     ma[:, sa.MA_PARAMS:sa.MA_PARAMS + sa.N_MAT_PARAMS])


def num_components(b: Bsdf):
    return (b.kind0 != LOBE_NONE).to(torch.int32) + (b.kind1 != LOBE_NONE).to(torch.int32)


def _lobe_f(kind, color, b: Bsdf, wo, wi, reflect):
    """One lobe slot's f for all lanes (specular lobes give 0)."""
    out = torch.where((kind == LOBE_LAMBERT)[:, None], color * INV_PI, 0.0)
    out = torch.where((kind == LOBE_ORENNAYAR)[:, None], oren_nayar_f(color, b.sigma, wo, wi), out)
    # reflective lobes contribute only on the reflecting side, with wo and wi
    # in the same shading hemisphere
    return torch.where((reflect & same_hemisphere(wo, wi))[:, None], out, 0.0)


def _lobe_pdf(kind, wo, wi):
    pdf_cos = abs_cos_theta(wi) * INV_PI
    out = torch.where((kind == LOBE_LAMBERT) | (kind == LOBE_ORENNAYAR), pdf_cos, 0.0)
    return torch.where(same_hemisphere(wo, wi), out, 0.0)


def bsdf_f(b: Bsdf, wo, wi, reflect):
    """f summed over the non-specular lobes (reflection.rs:355 Bsdf::f)."""
    return _lobe_f(b.kind0, b.r0, b, wo, wi, reflect) + _lobe_f(b.kind1, b.r1, b, wo, wi, reflect)


def bsdf_pdf(b: Bsdf, wo, wi):
    """The pdf averaged over the components (Bsdf::pdf)."""
    p = _lobe_pdf(b.kind0, wo, wi) + _lobe_pdf(b.kind1, wo, wi)
    n = num_components(b)
    return torch.where(n > 0, p / torch.clamp(n.to(torch.float32), min=1.0), 0.0)


def bsdf_sample(b: Bsdf, wo, u2, uc) -> BsdfSample:
    """Importance-sample the BSDF (reflection.rs:280 Bsdf::sample_f): uc
    picks a present lobe slot, u2 samples it (cosine hemisphere or the
    mirror direction); f and pdf combine the non-specular lobes."""
    n_comp = num_components(b).to(torch.float32)
    pick1 = (uc * torch.clamp(n_comp, min=1.0)) >= 1.0
    kind = torch.where(pick1, b.kind1, b.kind0)
    color = torch.where(pick1[:, None], b.r1, b.r0)
    wi = cosine_sample_hemisphere(u2)
    wi = wi * torch.sign(torch.where(cos_theta(wo) == 0, 1.0, cos_theta(wo)))[:, None]
    is_spec = kind == LOBE_SPEC_REFL
    wi_spec = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    wi = vm.normalize(torch.where(is_spec[:, None], wi_spec, wi))
    # delta lobes: the pdf of the discrete choice among the components
    pdf = torch.where(is_spec, 1.0 / torch.clamp(n_comp, min=1.0), bsdf_pdf(b, wo, wi))
    f = bsdf_f(b, wo, wi, same_hemisphere(wo, wi))
    # the mirror's f = R / |cos wi|, the delta absorbed
    aci = torch.clamp(abs_cos_theta(wi), min=1e-7)
    f = torch.where(is_spec[:, None], color / aci[:, None], f)
    none = num_components(b) == 0
    pdf = torch.where(none, 0.0, pdf)
    f = torch.where(none[:, None], 0.0, f)
    return BsdfSample(wi, f, pdf, is_spec, torch.zeros_like(is_spec))
