"""L1: the realistic camera's rays, one launch for a batch of camera lanes.

The port of the realistic branch of the JAX package's ``generate_rays``
(rs_pbrt_tpu/models/cameras.py:214-264) with its element loop
(rs_pbrt_tpu/models/realistic.py:231 ``trace_from_film_jnp``).
``lens_rays`` launches the CUDA kernel (``csrc/lens.cu``, the per-lane math
in ``csrc/lens.cuh``) for CUDA tensors and runs ``lens_rays_plain``, the
same function in plain PyTorch, op for op after the JAX code, for CPU
tensors.  Both take a realistic camera (``models/cameras.py``), the
lanes' raster points p_film (N, 2) and lens samples u_lens (N, 2), and
return the world-space origins and unit directions (N, 3) and the weights
(N,): 0 where the trace fails, the lane keeping the o and d the loop left.

The element loop's constants are the JAX loop's Python floats: each
element's f32 row read as a double, the element's z accumulated in
double, each product and quotient of them in double, rounded to f32 where
it meets a lane's f32 value (``element_consts``, ``lane_consts``).  A
realistic camera holds them as its ``lens_consts``, built once when the
camera is made (``lens_consts``).

Where a camera gradient is taken, ``lens_rays(..., camera_space=True)``
returns the rays in camera space and the weight without the shutter
factor (the same launch with an identity matrix and a factor of 1,
``camera_space_consts``), and ``models/cameras.generate_rays`` applies
cam_to_world and the shutter factor in PyTorch, where autograd records
them: the trace's own inputs (the film point, the lens sample and the
lens tables) are no leaves, so it needs no backward.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..utils import transform as tr
from ..utils.vecmath import true_div

MAX_ELEMENTS = 32  # csrc/lens.cuh kMaxElements
N_BINS = 64  # the exit pupil's bins (models/realistic.py N_PUPIL_BINS)
launches = 0  # kernel launches of `lens_rays`; the plain path does not count


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("lens").rs_lens_rays
    P, I = ctypes.c_void_p, ctypes.c_int
    # p_film, u_lens, o, d, w, n, lane, m, pupil, el, n_el, stream
    fn.argtypes = [P, P, P, P, P, I, P, P, P, P, I, P]
    fn.restype = ctypes.c_int
    return fn


def element_consts(lens: np.ndarray) -> np.ndarray:
    """(E, 8) f32, one row an element in trace order (rear first): sphere
    (0: the aperture stop), concave (curv < 0), z (the stop's plane or the
    sphere's centre), curv^2, the aperture radius^2, eta_i / eta_t and its
    square (csrc/lens.cuh's order), from trace_from_film_jnp's doubles."""
    rows = []
    element_z = 0.0
    E = lens.shape[0]
    for i in range(E - 1, -1, -1):
        curv, thick, eta, ap = (float(v) for v in lens[i])
        element_z -= thick
        if curv == 0.0:
            rows.append((0.0, 0.0, element_z, 0.0, ap * ap, 0.0, 0.0, 0.0))
            continue
        eta_t = float(lens[i - 1][2]) if (i > 0 and lens[i - 1][2] != 0.0) else 1.0
        er = eta / eta_t
        rows.append((1.0, float(curv < 0.0), element_z + curv, curv * curv, ap * ap, er, er * er,
                     0.0))
    return np.asarray(rows, np.float64).astype(np.float32)


def lane_consts(camera, lens: np.ndarray, pupil: np.ndarray) -> np.ndarray:
    """(12,) f32 in csrc/lens.cuh's order: the film's raster size, the
    film's x and y extent and their negated halves, half the diagonal,
    the rear element's z, the first pupil bin's area (simple weighting),
    shutter_close - shutter_open (f32), the rear z squared, the weighting
    mode; each from the JAX branch's doubles.  lens, pupil: the camera's
    rows on the host."""
    sx, sy = camera.resolution
    aspect = sy / sx
    x_ext = float(np.sqrt(camera.film_diag ** 2 / (1.0 + aspect * aspect)))
    y_ext = aspect * x_ext
    rear_z = float(lens[-1, 1])
    area0 = float(max((pupil[0, 2] - pupil[0, 0]) * (pupil[0, 3] - pupil[0, 1]), 1e-20))
    # the shutter may be 0-d tensors (a camera gradient's leaves)
    host = lambda v: np.float32(v.detach().cpu() if torch.is_tensor(v) else v)
    wscale = float(host(camera.shutter_close) - host(camera.shutter_open))
    return np.asarray([sx, sy, x_ext, -x_ext / 2.0, y_ext, -y_ext / 2.0, camera.film_diag / 2.0,
                       rear_z, area0, wscale, rear_z * rear_z, float(camera.simple_weighting)],
                      np.float64).astype(np.float32)


class LensConsts(NamedTuple):
    """L1's launch constants, contiguous f32 host arrays."""
    lane: np.ndarray  # (12,) lane_consts
    el: np.ndarray  # (E, 8) element_consts, rear element first
    pupil: np.ndarray  # (64, 4) the exit pupil's bounds by film radius
    m: np.ndarray  # (4, 4) cam_to_world


def lens_consts(camera) -> LensConsts:
    """A realistic camera's L1 constants from its lens, pupil_bounds,
    cam_to_world, resolution, film_diag, shutter and weighting."""
    host = lambda t: np.ascontiguousarray(t.detach().cpu().numpy(), np.float32)
    lens, pupil = host(camera.lens), host(camera.pupil_bounds)
    return LensConsts(lane_consts(camera, lens, pupil), np.ascontiguousarray(element_consts(lens)),
                      pupil, host(camera.cam_to_world))


def camera_space_consts(k: LensConsts) -> LensConsts:
    """k for rays left in camera space: cam_to_world the identity and the
    non-simple weight's shutter factor 1."""
    lane = k.lane.copy()
    lane[9] = 1.0
    return k._replace(lane=lane, m=np.eye(4, dtype=np.float32))


def _norm(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """vecmath.normalize with its sums in order."""
    x, y, z = v.unbind(-1)
    ln = torch.clamp(torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-30)), min=1e-20)
    return v / ln[:, None]


def lens_rays_plain(camera, p_film: torch.Tensor, u_lens: torch.Tensor, work: dict = None,
                    camera_space: bool = False):
    """The JAX realistic branch in plain PyTorch: (o, d, weight); with
    camera_space, through camera_space_consts.  work, when given, gains
    "stop" and "sphere": the (lane, element) pairs the trace reaches before
    the lane's first failed test (what the kernel computes)."""
    k = camera_space_consts(camera.lens_consts) if camera_space else camera.lens_consts
    res_x, res_y, x_ext, nhx, y_ext, nhy, half_diag, rear_z, area0, wscale, rz2, simple = (
        float(v) for v in k.lane)
    s = p_film / p_film.new_tensor([res_x, res_y])
    p2x = nhx + s[:, 0] * x_ext
    p2y = nhy + s[:, 1] * y_ext
    fx, fy = -p2x, p2y
    r_film = torch.sqrt(fx * fx + fy * fy)
    bin_i = torch.clamp((true_div(r_film, half_diag) * N_BINS).to(torch.int32), 0, N_BINS - 1)
    pb = camera.pupil_bounds[bin_i.long()]
    area = torch.clamp((pb[:, 2] - pb[:, 0]) * (pb[:, 3] - pb[:, 1]), min=0.0)
    u0, u1 = u_lens[:, 0], u_lens[:, 1]
    lx = (1.0 - u0) * pb[:, 0] + u0 * pb[:, 2]
    ly = (1.0 - u1) * pb[:, 1] + u1 * pb[:, 3]
    pos = r_film > 0
    rf = torch.clamp(r_film, min=1e-20)
    sin_t = torch.where(pos, fy / rf, 0.0)
    cos_t = torch.where(pos, fx / rf, 1.0)
    dfx = cos_t * lx - sin_t * ly - fx
    dfy = sin_t * lx + cos_t * ly - fy
    dfz = torch.full_like(lx, rear_z)
    # trace_from_film_jnp, in the flipped frame (z negated)
    ox, oy, oz = fx, fy, torch.zeros_like(fx) * -1.0
    dx, dy, dz = dfx, dfy, dfz * -1.0
    ok = torch.ones_like(fx, dtype=torch.bool)
    for sphere, concave, z, c2, ap2, er, er2, _ in (tuple(float(v) for v in row)
                                                     for row in k.el):
        if work is not None:
            key = "sphere" if sphere else "stop"
            work[key] = work.get(key, 0) + int(ok.sum())
        if not sphere:
            ok = ok & (dz < 0.0)
            t = (z - oz) / torch.where(dz == 0, 1e-12, dz)
        else:
            ocz = oz - z
            a = dx * dx + dy * dy + dz * dz
            b = 2.0 * (dx * ox + dy * oy + dz * ocz)
            c = (ox * ox + oy * oy + ocz * ocz) - c2
            disc = b * b - 4.0 * a * c
            ok = ok & (disc >= 0.0)
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            q = torch.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
            t0 = q / torch.where(a == 0, 1e-12, a)
            t1 = c / torch.where(q == 0, 1e-12, q)
            closer = (dz > 0.0) ^ bool(concave)
            t = torch.where(closer, torch.minimum(t0, t1), torch.maximum(t0, t1))
            ok = ok & (t >= 0.0)
            hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
            hz_c = hz - z
            ln = torch.clamp(_norm(hx, hy, hz_c), min=1e-12)
            nx, ny, nz = hx / ln, hy / ln, hz_c / ln
            flip = (nx * -dx + ny * -dy + nz * -dz) < 0.0
            nx, ny, nz = (torch.where(flip, -v, v) for v in (nx, ny, nz))
        hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
        r2 = hx * hx + hy * hy
        ok = ok & (r2 <= ap2)
        ox, oy, oz = (torch.where(ok, h, v) for h, v in ((hx, ox), (hy, oy), (hz, oz)))
        if sphere:
            ln = torch.clamp(_norm(dx, dy, dz), min=1e-12)
            wix, wiy, wiz = -(dx / ln), -(dy / ln), -(dz / ln)
            cos_i = nx * wix + ny * wiy + nz * wiz
            sin2_t = er2 * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
            ct = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
            g = er * cos_i - ct
            ok = ok & (sin2_t < 1.0)
            dx, dy, dz = (torch.where(ok, -wi * er + n * g, v)
                          for wi, n, v in ((wix, nx, dx), (wiy, ny, dy), (wiz, nz, dz)))
    o_out = torch.stack([ox, oy, oz * -1.0], -1)
    d_out = torch.stack([dx, dy, dz * -1.0], -1)
    m = torch.as_tensor(k.m, device=p_film.device) if camera_space else camera.cam_to_world
    o = tr.xform_point(m, o_out)
    d = _normalize(tr.xform_vector(m, d_out))
    cos_theta = dfz / torch.clamp(torch.sqrt(torch.clamp(dfx * dfx + dfy * dfy + dfz * dfz,
                                                         min=1e-30)), min=1e-20)
    c2 = cos_theta * cos_theta
    cos4 = c2 * c2
    if simple:
        w = true_div(cos4 * area, area0)
    else:
        w = true_div(wscale * cos4 * area, rz2)
    return o, d, torch.where(ok, w, 0.0)


def _check_args(camera, p_film: torch.Tensor, u_lens: torch.Tensor):
    """Raises on what the kernel does not take, on any device."""
    n = p_film.shape[0] if p_film.dim() == 2 else -1
    for name, x in (("p_film", p_film), ("u_lens", u_lens)):
        if x.dtype != torch.float32 or x.shape != (n, 2) or not x.is_contiguous():
            raise ValueError(f"lens_rays: {name} must be a contiguous (N, 2) float32 tensor")
    if p_film.device != u_lens.device or p_film.device != camera.device:
        raise ValueError("lens_rays: p_film, u_lens and the camera must lie on one device")
    k = camera.lens_consts
    e = k.el.shape[0] if k is not None else 0
    if not 1 <= e <= MAX_ELEMENTS:
        raise ValueError(f"lens_rays: {e} lens elements; the kernel takes 1..{MAX_ELEMENTS}")
    if k.pupil.shape != (N_BINS, 4):
        raise ValueError(f"lens_rays: the exit pupil must have {N_BINS} bins")
    if n >= 1 << 31:
        raise ValueError("lens_rays: at most 2^31 - 1 lanes per launch")


def lens_rays(camera, p_film: torch.Tensor, u_lens: torch.Tensor, camera_space: bool = False):
    """(o, d, weight) of a realistic camera's lanes: the kernel for CUDA
    tensors, the plain version for CPU ones; with camera_space, the rays in
    camera space and the weight without the shutter factor."""
    _check_args(camera, p_film, u_lens)
    if p_film.device.type == "cpu":
        return lens_rays_plain(camera, p_film, u_lens, camera_space=camera_space)
    global launches
    if p_film.device.type != "cuda":
        raise ValueError(f"lens_rays: the lanes lie on {p_film.device}")
    n = p_film.shape[0]
    o = torch.empty((n, 3), dtype=torch.float32, device=p_film.device)
    d = torch.empty((n, 3), dtype=torch.float32, device=p_film.device)
    w = torch.empty(n, dtype=torch.float32, device=p_film.device)
    k = camera_space_consts(camera.lens_consts) if camera_space else camera.lens_consts
    with torch.cuda.device(p_film.device):
        err = _kernel()(p_film.data_ptr(), u_lens.data_ptr(), o.data_ptr(), d.data_ptr(),
                        w.data_ptr(), n, k.lane.ctypes.data, k.m.ctypes.data, k.pupil.ctypes.data,
                        k.el.ctypes.data, k.el.shape[0], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lens kernel launch")
    launches += 1
    return o, d, w
