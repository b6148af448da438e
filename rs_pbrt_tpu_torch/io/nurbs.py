"""NURBS surface tessellation: the port's copy of the JAX package's
``io/nurbs.py`` (reference src/shapes/nurbs.rs).  The rational B-spline
surface is evaluated on a (diceu x dicev) grid when the scene is parsed
and becomes a triangle mesh (nurbs.rs, api.rs:2050), with a vectorized
Cox-de Boor basis (host numpy)."""

from __future__ import annotations

import numpy as np


def _basis(knots, order, ncp, t):
    """Cox-de Boor basis functions.  knots: (ncp+order,), t: (M,).
    Returns (M, ncp) basis values of degree order-1."""
    knots = np.asarray(knots, np.float64)
    t = np.asarray(t, np.float64)
    m = t.shape[0]
    n_spans = len(knots) - 1
    # degree 0
    N = np.zeros((m, n_spans))
    for i in range(n_spans):
        if i == ncp - 1 and knots[i] < knots[i + 1]:
            # make the last interval closed so t = t_max evaluates
            N[:, i] = (t >= knots[i]) & (t <= knots[i + 1])
        else:
            N[:, i] = (t >= knots[i]) & (t < knots[i + 1])
    for d in range(1, order):
        N2 = np.zeros((m, n_spans - d))
        for i in range(n_spans - d):
            den1 = knots[i + d] - knots[i]
            den2 = knots[i + d + 1] - knots[i + 1]
            a = (t - knots[i]) / den1 if den1 > 0 else 0.0
            b = (knots[i + d + 1] - t) / den2 if den2 > 0 else 0.0
            N2[:, i] = a * N[:, i] + b * N[:, i + 1]
        N = N2
    return N[:, :ncp]


def evaluate_surface(u_order, u_knot, ucp, v_order, v_knot, vcp, P, w, us, vs):
    """Evaluate at the grid us x vs.  P: (vcp, ucp, 3), w: (vcp, ucp).
    Returns points (len(vs), len(us), 3)."""
    Bu = _basis(u_knot, u_order, ucp, us)  # (MU, ucp)
    Bv = _basis(v_knot, v_order, vcp, vs)  # (MV, vcp)
    Pw = P * w[..., None]  # homogeneous
    num = np.einsum("mj,jkc,nk->mnc", Bv, Pw, Bu)
    den = np.einsum("mj,jk,nk->mn", Bv, w, Bu)
    return num / np.maximum(den[..., None], 1e-12)


def tessellate_nurbs(
    u_order, u_knot, ucp, v_order, v_knot, vcp, P, w=None, diceu=30, dicev=30
):
    """NURBS -> (V (N,3), F (M,3) triangle indices, UV (N,2)).
    P: flat (vcp*ucp, 3) control points row-major in v; w: weights or None."""
    P = np.asarray(P, np.float64).reshape(vcp, ucp, 3)
    w = np.ones((vcp, ucp)) if w is None else np.asarray(w, np.float64).reshape(vcp, ucp)
    u0, u1 = u_knot[u_order - 1], u_knot[ucp]
    v0, v1 = v_knot[v_order - 1], v_knot[vcp]
    us = np.linspace(u0, u1, diceu)
    vs = np.linspace(v0, v1, dicev)
    pts = evaluate_surface(u_order, u_knot, ucp, v_order, v_knot, vcp, P, w, us, vs)
    V = pts.reshape(-1, 3).astype(np.float32)
    uu, vv = np.meshgrid((us - u0) / max(u1 - u0, 1e-12), (vs - v0) / max(v1 - v0, 1e-12))
    UV = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)
    faces = []
    for j in range(dicev - 1):
        for i in range(diceu - 1):
            a = j * diceu + i
            b = a + 1
            c = a + diceu
            d = c + 1
            faces.append((a, b, d))
            faces.append((a, d, c))
    return V, np.asarray(faces, np.int32), UV
