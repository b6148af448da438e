"""S1: SPPM's photon deposit, the kernel's wrapper and its plain version.

The port of the scan of the JAX package's ``_deposit_events``
(models/integrators/sppm.py:335-382): every visible point (VP) scans the
event buckets of its 27 neighbour cells, up to ``max_ev`` rows each, of
the event table sorted by cell, and sums ``beta_w * f`` and ``w`` over the
events within its radius.  ``deposit`` launches the CUDA kernel
(``csrc/sppm.cu``) for CUDA tensors and runs ``deposit_plain`` for CPU
tensors.  ``models/integrators/sppm.deposit_events`` builds the inputs as
the JAX function builds them.

A VP's BSDF is one Lambert, Oren-Nayar or hair lobe (kind its tag, coef
its wo terms), or in a scene of the other materials a general one (kind
GENERAL and a row of GEN_COLS, ``pack_general``: up to six slots of
reflecting lobes and the Fourier lobe, which the kernel evaluates whole,
``csrc/bxdf.cuh``).

Inputs: rows (E, 11) f32, the sorted events ``[p(3), wi(3), beta*w(3), w,
cell]``; start27 (27, P) int64, each neighbour cell's first row;
okc27 (27, P) bool, the neighbour cell lies in the grid and the VP is
valid; nbf27 (27, P) f32, the neighbour cell's id; per VP its point p, its
shading frame (ss, ts, ns) (P, 3) each, wo in that frame (P, 3), r2 (P,)
and its Bsdf.  Outputs phi (P, 3) and m (P,).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .autodiff import refuse_grad
from . import bsdf as bx

launches = {"sppm_deposit": 0}  # kernel launches; the plain version does not count

N_NEIGHBOURS = 27
ROW_COLS = 11
VP_COLS = 19  # p, ss, ts, ns, wo, r2, color: csrc/sppm.cu kVpCols
N_COEFS = 44  # csrc/sppm.cu kCoefs
KERNEL_LOBES = (bx.LOBE_LAMBERT, bx.LOBE_ORENNAYAR, bx.LOBE_HAIR)
GENERAL = -1  # the kind of a VP whose BSDF the kernel evaluates whole
GEN_COLS = 38  # csrc/bxdf.cuh kGenCols
# the lobes of the earlier slices' materials, which one-lobe VPs have
_BASE_LOBES = bx.lobe_mask_of(bx.BASE_MATERIALS)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("sppm").rs_sppm_deposit
    # rows, n_ev, start, okc, nbf, vps, kind, coef, gen, the Fourier table's mu, dense, m,
    # cdf, a0, n_mu and eta, n_vp, max_ev, phi, m, stream
    fn.argtypes = [_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P,
                   _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _dot3(a, b):
    """a . b over the last axis, summed x, y, z in that order (the kernel's)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _take_bsdf(b: bx.Bsdf, idx) -> bx.Bsdf:
    return b._replace(**{k: getattr(b, k)[idx] for k in b._fields
                         if torch.is_tensor(getattr(b, k))})


F_CHUNK = 1 << 22  # (VP, event) pairs whose f deposit_plain evaluates at once


def deposit_plain(rows, start27, okc27, nbf27, vp_p, ss, ts, ns, wo_l, r2, b: bx.Bsdf,
                  max_ev: int, work: dict = None):
    """The JAX scan in plain PyTorch, its sums taken step by step in its
    order (neighbour cell, then row k of its bucket): the rows each VP
    keeps are found for all k of a cell at once, f is evaluated on every
    kept (VP, event) pair (F_CHUNK at a time), and then, as the scan's
    carry does, phi += beta_w f and m += w step by step, 0 where a VP keeps
    nothing.  work, when given, gains the (VP, event) pairs tested (in
    their bucket), the near ones (kept) and the near ones of each lobe
    (lambert_near, oren_nayar_near, hair_near)."""
    n_vp, n_ev, dev = vp_p.shape[0], rows.shape[0], vp_p.device
    ks = torch.arange(max_ev, dtype=torch.int64, device=dev)
    kept = []  # per neighbour cell: (k, lane, row) of its kept pairs, k-major
    for ci in range(N_NEIGHBOURS):
        e_raw = start27[ci][None, :] + ks[:, None]  # (K, P)
        e = torch.clamp(e_raw, 0, n_ev - 1)
        in_b = (rows[:, 10][e] == nbf27[ci][None, :]) & (e_raw < n_ev) & okc27[ci][None, :]
        d = rows[:, 0:3][e] - vp_p[None]
        k, lane = (in_b & (_dot3(d, d) <= r2[None, :])).nonzero(as_tuple=True)
        kept.append((k, lane, e[k, lane]))
        if work is not None:
            work["tested"] = work.get("tested", 0) + int(in_b.sum())
    lane = torch.cat([x[1] for x in kept])
    row = rows[torch.cat([x[2] for x in kept])]
    contrib = torch.empty((lane.shape[0], 3), device=dev)
    for at in range(0, lane.shape[0], F_CHUNK):
        sl, ls = slice(at, at + F_CHUNK), lane[at:at + F_CHUNK]
        wi = row[sl, 3:6]
        wi_l = torch.stack([_dot3(wi, ss[ls]), _dot3(wi, ts[ls]), _dot3(wi, ns[ls])], -1)
        f = bx.bsdf_f(_take_bsdf(b, ls), wo_l[ls], wi_l,
                      torch.ones(ls.shape[0], dtype=torch.bool, device=dev))
        contrib[sl] = row[sl, 6:9] * f
    phi = torch.zeros((n_vp, 3), device=dev)
    m = torch.zeros(n_vp, device=dev)
    at = 0
    for k, ls, _ in kept:
        n = ls.shape[0]
        step_phi = torch.zeros((max_ev, n_vp, 3), device=dev)
        step_phi[k, ls] = contrib[at:at + n]
        step_m = torch.zeros((max_ev, n_vp), device=dev)
        step_m[k, ls] = row[at:at + n, 9]
        for kk in range(max_ev):
            phi = phi + step_phi[kk]
            m = m + step_m[kk]
        at += n
    if work is not None:
        work["near"] = work.get("near", 0) + int(lane.shape[0])
        for key, kind in (("lambert_near", bx.LOBE_LAMBERT), ("oren_nayar_near", bx.LOBE_ORENNAYAR),
                          ("hair_near", bx.LOBE_HAIR)):
            work[key] = work.get(key, 0) + int((b.kind0[lane] == kind).sum())
    return phi, m


def is_general(b: bx.Bsdf) -> bool:
    """Whether b's lanes may hold lobes beyond one Lambert, Oren-Nayar or
    hair lobe (the scene has materials of the later slices)."""
    return bool(b.lobe_mask & ~_BASE_LOBES)


def pack_general(b: bx.Bsdf):
    """(P, GEN_COLS) f32, each VP's general row (csrc/bxdf.cuh): the six
    slots' tags and colors (absent slots none and black), the base ax, ay,
    eta, sigma, slots 2 and 3's, eta3 and k3."""
    slots = bx._slots(b)
    kinds = [k.to(torch.float32) for k, _, _ in slots]
    kinds += [torch.zeros_like(kinds[0])] * (6 - len(slots))
    colors = [c for _, c, _ in slots] + [torch.zeros_like(b.r0)] * (6 - len(slots))
    base = [b.ax, b.ay, b.eta, b.sigma]
    s23 = [b.ax2, b.ay2, b.eta2, b.sigma2] if b.ax2 is not None else base
    return torch.cat([torch.stack(kinds, -1)] + colors
                     + [torch.stack(base + s23, -1), b.eta3, b.k3], -1).contiguous()


def pack_vps(vp_p, ss, ts, ns, wo_l, r2, b: bx.Bsdf):
    """The kernel's per-VP inputs: (P, 19) f32 [p, ss, ts, ns, wo, r2,
    color], (P,) int32 lobe tags and (P, 44) f32 of the lobe's wo terms:
    Oren-Nayar's A, B, sin theta_o, cos phi_o, sin phi_o and |cos theta_o|
    in 0-5; the hair lobe's Mp terms of its 4 variances (v, 1/v, log(1/2v),
    2 v sinh(1/v)) in 0-15, its tilted sin/cos theta_o of lobes 0-2 in
    16-21, sin and cos theta_o, phi_o and s in 22-25, Np's phi(p) and
    normalization of lobes 0-2 in 26-31 and the attenuations A_0..A_3 in
    32-43 (ops/bsdf.hair_wo_terms); then the general rows (pack_general, or
    None where b is not general) and the Fourier table (or None).  A
    general b's VPs other than hair's take kind GENERAL."""
    vps = torch.cat([vp_p, ss, ts, ns, wo_l, r2[:, None], b.r0], 1).contiguous()
    a_on, b_on = bx.oren_nayar_ab(b.sigma)
    sin_to = torch.sqrt(torch.clamp(bx.sin2_theta(wo_l), min=1e-24))
    cols = [a_on, b_on, sin_to, bx.cos_phi(wo_l), bx.sin_phi(wo_l), bx.abs_cos_theta(wo_l)]
    coef = torch.zeros((vp_p.shape[0], N_COEFS), device=vp_p.device)
    coef[:, :len(cols)] = torch.stack(cols, -1)
    if bx._has_lobe(b, bx.LOBE_HAIR):
        w = bx.hair_wo_terms(b, wo_l)
        hair = [x for vt in w["vt"] for x in vt] + [x for t in w["tilts"] for x in t]
        hair += [w["sin_to"], w["cos_to"], w["phi_o"], w["s"]]
        hair += [x for t in w["np"] for x in t]
        hair = torch.cat([torch.stack(hair, -1)] + w["ap"], -1)
        coef = torch.where((b.kind0 == bx.LOBE_HAIR)[:, None], hair, coef)
    kind, gen = b.kind0.to(torch.int32), None
    if is_general(b):
        kind = torch.where(b.kind0 == bx.LOBE_HAIR, kind, GENERAL)
        gen = pack_general(b)
    return vps, kind.contiguous(), coef.contiguous(), gen, b.fou


def check_lobes(okc27, b: bx.Bsdf):
    """Raises ValueError where a VP that scans a cell has a lobe the kernel
    does not evaluate: in a scene of the earlier slices' materials anything
    but one Lambert, Oren-Nayar or hair lobe (glass and mirror store no
    VP); in a general one a hair lobe beside another (a mix's), or the
    Beckmann distribution."""
    valid = okc27.any(0)
    hair = bx._has_lobe(b, bx.LOBE_HAIR)
    if is_general(b):
        if b.use_beckmann:
            raise ValueError("sppm deposit: the kernel evaluates TrowbridgeReitz lobes only")
        hair0 = b.kind0 == bx.LOBE_HAIR
        ok = ~hair0 | hair
        for k, _, _ in bx._slots(b)[1:]:
            ok = ok & (k != bx.LOBE_HAIR) & (~hair0 | (k == bx.LOBE_NONE))
    else:
        ok = (b.kind1 == bx.LOBE_NONE) & (
            (b.kind0 == bx.LOBE_LAMBERT) | (b.kind0 == bx.LOBE_ORENNAYAR)
            | ((b.kind0 == bx.LOBE_HAIR) & hair))
    bad = valid & ~ok
    if bool(bad.any()):
        kinds = sorted(set(b.kind0[bad].tolist()) | set(b.kind1[bad].tolist()))
        raise ValueError(f"sppm deposit: visible points with lobes {kinds}; the kernel "
                         f"evaluates {KERNEL_LOBES} only")


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"sppm deposit: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"sppm deposit: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def deposit(rows, start27, okc27, nbf27, vp_p, ss, ts, ns, wo_l, r2, b: bx.Bsdf, max_ev: int):
    """S1: (phi (P, 3), m (P,)), the deposit of the sorted events on the VPs
    (see the module's docstring); the plain version on the CPU."""
    refuse_grad("deposit (S1)", rows, vp_p, ss, ts, ns, wo_l, r2, *b)
    if rows.device.type == "cpu":
        return deposit_plain(rows, start27, okc27, nbf27, vp_p, ss, ts, ns, wo_l, r2, b, max_ev)
    check_lobes(okc27, b)
    return launch(rows, start27, okc27, nbf27, *pack_vps(vp_p, ss, ts, ns, wo_l, r2, b), max_ev)


def launch(rows, start27, okc27, nbf27, vps, kind, coef, gen, fou, max_ev: int):
    """S1's launch on inputs packed by pack_vps (lobes checked by
    check_lobes): -> (phi, m).  It reads nothing back from the card."""
    n_vp, n_ev = vps.shape[0], rows.shape[0]
    _check("rows", rows, torch.float32, (n_ev, ROW_COLS))
    _check("start27", start27, torch.int64, (N_NEIGHBOURS, n_vp))
    _check("okc27", okc27, torch.bool, (N_NEIGHBOURS, n_vp))
    _check("nbf27", nbf27, torch.float32, (N_NEIGHBOURS, n_vp))
    _check("vps", vps, torch.float32, (n_vp, VP_COLS))
    _check("kind", kind, torch.int32, (n_vp,))
    _check("coef", coef, torch.float32, (n_vp, N_COEFS))
    if gen is not None:
        _check("gen", gen, torch.float32, (n_vp, GEN_COLS))
    table = (0, 0, 0, 0, 0, 0, 0)
    if fou is not None:
        for name, t, dtype in (("mu", fou.mu, torch.float32), ("dense", fou.dense, torch.float32),
                               ("m", fou.m, torch.int32), ("cdf", fou.cdf, torch.float32),
                               ("a0", fou.a0, torch.float32), ("eta", fou.eta, torch.float32)):
            _check(name, t, dtype, t.shape)
        table = (fou.mu.data_ptr(), fou.dense.data_ptr(), fou.m.data_ptr(), fou.cdf.data_ptr(),
                 fou.a0.data_ptr(), fou.mu.shape[0], fou.eta.data_ptr())
    if not 0 < n_ev < (1 << 62) // ROW_COLS or n_vp >= (1 << 31) // N_NEIGHBOURS:
        raise ValueError(f"sppm deposit: {n_ev} events, {n_vp} visible points")
    if max_ev < 1:
        raise ValueError(f"sppm deposit: max_ev {max_ev}")
    phi = torch.empty((n_vp, 3), dtype=torch.float32, device=rows.device)
    m = torch.empty(n_vp, dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        err = _kernel()(rows.data_ptr(), n_ev, start27.data_ptr(), okc27.data_ptr(),
                        nbf27.data_ptr(), vps.data_ptr(), kind.data_ptr(), coef.data_ptr(),
                        0 if gen is None else gen.data_ptr(), *table, n_vp, int(max_ev),
                        phi.data_ptr(), m.data_ptr(),
                        torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check(err, "sppm deposit kernel launch")
    launches["sppm_deposit"] += 1
    return phi, m
