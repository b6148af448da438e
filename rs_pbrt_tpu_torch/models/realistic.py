"""The realistic (lens-system) camera's host half (reference
src/cameras/realistic.rs).

The port's copy of the numpy functions of the JAX package's
``models/realistic.py``: the lens rows, the vectorized traces through the
element stack in float64, thick-lens focusing and the 64-bin exit-pupil
bounds, all computed once when the camera is made.  They give the JAX
package's arrays bit for bit.  The render-time trace of every camera lane
is L1 (``ops/lens_kernel.py``).

Lens-space convention as the reference's (realistic.rs:266-327): film at
z=0, elements along +z after the scale(1,1,-1) flip; element rows are
(curvature_radius, thickness, eta, aperture_radius) in meters, front
(scene side) first.
"""

from __future__ import annotations

import numpy as np

N_PUPIL_BINS = 64


def parse_lens_data(lens_data, aperture_diameter_mm):
    """lens_data: flat mm-unit rows of 4 (realistic.rs:61-80) -> (E,4) m."""
    d = np.asarray(lens_data, np.float64).reshape(-1, 4)
    el = np.zeros_like(d)
    el[:, 0] = d[:, 0] * 0.001
    el[:, 1] = d[:, 1] * 0.001
    el[:, 2] = d[:, 2]
    diam = d[:, 3].copy()
    stop = d[:, 0] == 0.0
    diam[stop] = np.minimum(diam[stop], aperture_diameter_mm)
    el[:, 3] = diam * 0.001 / 2.0
    return el


def _refract_np(wi, n, eta_ratio):
    """vector refract (w.r.t. incident side normal), numpy masked."""
    cos_i = (n * wi).sum(-1)
    sin2_i = np.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    ok = sin2_t < 1.0
    cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
    wt = -wi * eta_ratio + n * (eta_ratio * cos_i - cos_t)[..., None]
    return ok, wt


def trace_from_film_np(elements, o, d):
    """Vectorized trace_lenses_from_film (realistic.rs:266-327).
    o,d: (N,3) in CAMERA space; returns (ok, o_out, d_out) camera space."""
    o = np.asarray(o, np.float64).copy()
    d = np.asarray(d, np.float64).copy()
    o[:, 2] *= -1.0
    d[:, 2] *= -1.0
    ok = np.ones(o.shape[0], bool)
    element_z = 0.0
    E = elements.shape[0]
    for i in range(E - 1, -1, -1):
        curv, thick, eta, ap = elements[i]
        element_z -= thick
        if curv == 0.0:
            ok &= d[:, 2] < 0.0
            t = (element_z - o[:, 2]) / np.where(d[:, 2] == 0, 1e-12, d[:, 2])
            n = None
        else:
            z_center = element_z + curv
            oc = o.copy()
            oc[:, 2] -= z_center
            a = (d * d).sum(-1)
            b = 2.0 * (d * oc).sum(-1)
            c = (oc * oc).sum(-1) - curv * curv
            disc = b * b - 4 * a * c
            ok &= disc >= 0.0
            sq = np.sqrt(np.maximum(disc, 0.0))
            q = np.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
            t0 = q / np.where(a == 0, 1e-12, a)
            t1 = c / np.where(q == 0, 1e-12, q)
            use_closer = (d[:, 2] > 0.0) ^ (curv < 0.0)
            t = np.where(use_closer, np.minimum(t0, t1), np.maximum(t0, t1))
            ok &= t >= 0.0
            p = o + t[:, None] * d
            n = p.copy()
            n[:, 2] -= z_center
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            flip = (n * (-d)).sum(-1) < 0.0
            n[flip] *= -1.0
        p = o + t[:, None] * d
        r2 = p[:, 0] ** 2 + p[:, 1] ** 2
        ok &= r2 <= ap * ap
        o = np.where(ok[:, None], p, o)
        if curv != 0.0:
            eta_i = eta
            eta_t = elements[i - 1][2] if (i > 0 and elements[i - 1][2] != 0.0) else 1.0
            dn = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
            rok, wt = _refract_np(-dn, n, eta_i / eta_t)
            ok &= rok
            d = np.where(ok[:, None], wt, d)
    o_out = o.copy()
    d_out = d.copy()
    o_out[:, 2] *= -1.0
    d_out[:, 2] *= -1.0
    return ok, o_out, d_out


def trace_from_scene_np(elements, o, d):
    """Vectorized trace_lenses_from_scene (realistic.rs:366-421)."""
    o = np.asarray(o, np.float64).copy()
    d = np.asarray(d, np.float64).copy()
    o[:, 2] *= -1.0
    d[:, 2] *= -1.0
    ok = np.ones(o.shape[0], bool)
    element_z = -elements[:, 1].sum()
    E = elements.shape[0]
    for i in range(E):
        curv, thick, eta, ap = elements[i]
        if curv == 0.0:
            t = (element_z - o[:, 2]) / np.where(d[:, 2] == 0, 1e-12, d[:, 2])
            n = None
        else:
            z_center = element_z + curv
            oc = o.copy()
            oc[:, 2] -= z_center
            a = (d * d).sum(-1)
            b = 2.0 * (d * oc).sum(-1)
            c = (oc * oc).sum(-1) - curv * curv
            disc = b * b - 4 * a * c
            ok &= disc >= 0.0
            sq = np.sqrt(np.maximum(disc, 0.0))
            q = np.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
            t0 = q / np.where(a == 0, 1e-12, a)
            t1 = c / np.where(q == 0, 1e-12, q)
            use_closer = (d[:, 2] > 0.0) ^ (curv < 0.0)
            t = np.where(use_closer, np.minimum(t0, t1), np.maximum(t0, t1))
            ok &= t >= 0.0
            p = o + t[:, None] * d
            n = p.copy()
            n[:, 2] -= z_center
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            flip = (n * (-d)).sum(-1) < 0.0
            n[flip] *= -1.0
        p = o + t[:, None] * d
        r2 = p[:, 0] ** 2 + p[:, 1] ** 2
        ok &= r2 <= ap * ap
        o = np.where(ok[:, None], p, o)
        if curv != 0.0:
            eta_i = 1.0 if (i == 0 or elements[i - 1][2] == 0.0) else elements[i - 1][2]
            eta_t = eta if eta != 0.0 else 1.0
            dn = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
            rok, wt = _refract_np(-dn, n, eta_i / eta_t)
            ok &= rok
            d = np.where(ok[:, None], wt, d)
        element_z += thick
    o_out = o.copy()
    d_out = d.copy()
    o_out[:, 2] *= -1.0
    d_out[:, 2] *= -1.0
    return ok, o_out, d_out


def _cardinal_points(o_in, o_out, d_out):
    tf = -o_out[0] / d_out[0]
    fz = -(o_out[2] + tf * d_out[2])
    tp = (o_in[0] - o_out[0]) / d_out[0]
    pz = -(o_out[2] + tp * d_out[2])
    return pz, fz


def focus_thick_lens(elements, focus_distance, film_diag):
    """realistic.rs:444-499: rear-element thickness that focuses at
    focus_distance."""
    lens_front_z = elements[:, 1].sum()
    lens_rear_z = elements[-1, 1]
    x = 0.001 * film_diag
    ok, o_f, d_f = trace_from_scene_np(
        elements, np.array([[x, 0.0, lens_front_z + 1.0]]), np.array([[0.0, 0.0, -1.0]])
    )
    assert ok[0], "thick-lens: scene->film trace failed"
    pz0, fz0 = _cardinal_points(np.array([x, 0.0, lens_front_z + 1.0]), o_f[0], d_f[0])
    ok, o_s, d_s = trace_from_film_np(
        elements, np.array([[x, 0.0, lens_rear_z - 1.0]]), np.array([[0.0, 0.0, 1.0]])
    )
    assert ok[0], "thick-lens: film->scene trace failed"
    pz1, fz1 = _cardinal_points(np.array([x, 0.0, lens_rear_z - 1.0]), o_s[0], d_s[0])
    f = fz0 - pz0
    z = -focus_distance
    c = (pz1 - z - pz0) * (pz1 - z - 4.0 * f - pz0)
    assert c > 0.0, "focus_distance too short for this lens"
    delta = 0.5 * (pz1 - z + pz0 - np.sqrt(c))
    return elements[-1, 1] + delta


def bound_exit_pupil(elements, x0, x1, n_side=256):
    """realistic.rs:573-652 with an n_side^2 stratified probe grid."""
    rear_radius = elements[-1, 3]
    rear_z = elements[-1, 1]
    half = 1.5 * rear_radius
    n = n_side * n_side
    i = np.arange(n)
    px = ((i % n_side) + 0.5) / n_side
    py = ((i // n_side) + 0.5) / n_side
    p_rear = np.stack(
        [(-half) + px * 2 * half, (-half) + py * 2 * half, np.full(n, rear_z)], -1
    )
    fx = x0 + (i + 0.5) / n * (x1 - x0)
    p_film = np.stack([fx, np.zeros(n), np.zeros(n)], -1)
    ok, _, _ = trace_from_film_np(elements, p_film, p_rear - p_film)
    if not ok.any():
        return np.array([-half, -half, half, half])
    qx = p_rear[ok, 0]
    qy = p_rear[ok, 1]
    pad = 2.0 * np.sqrt((2 * half) ** 2 * 2) / n_side
    return np.array([qx.min() - pad, qy.min() - pad, qx.max() + pad, qy.max() + pad])


def build_exit_pupil_bounds(elements, film_diag, n_bins=N_PUPIL_BINS):
    bounds = np.zeros((n_bins, 4), np.float32)
    for i in range(n_bins):
        r0 = i / n_bins * film_diag / 2.0
        r1 = (i + 1) / n_bins * film_diag / 2.0
        bounds[i] = bound_exit_pupil(elements, r0, r1)
    return bounds
