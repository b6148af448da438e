"""Cameras as batched ray generators.

The port of the JAX package's ``models/cameras.py`` (reference
src/core/camera.rs, src/cameras/*.rs): the perspective, orthographic,
environment and realistic (lens-system) cameras, depth of field for the two
projective ones and camera motion between two shutter ends
(AnimatedTransform, ``utils/animated.py``).  The realistic camera's lanes
go through L1 (``ops/lens_kernel.py``) on the card.  Near clipping
(``clipping_start``, set only by the .blend importer) comes with the front
ends (ROADMAP A18).  BDPT's importance functions ``camera_we``,
``camera_pdf_we`` and ``camera_sample_wi`` are the pinhole perspective
camera's formulas from the static ``cam_to_world``, whatever the camera's
type or motion, as in the JAX package (its cameras.py:330-392); the two
inverses they read are computed once a camera.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve
from ..ops import lens_kernel
from ..ops.sampling import concentric_sample_disk
from ..utils import animated as anim
from ..utils import transform as tr
from ..utils import vecmath as vm
from ..utils.vecmath import PI, normalize

# the JAX package's camera type tags
PERSPECTIVE = 0
ORTHOGRAPHIC = 1
ENVIRONMENT = 2
REALISTIC = 3


@dataclass
class Camera:
    cam_to_world: torch.Tensor  # (4,4)
    raster_to_camera: torch.Tensor  # (4,4)
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    resolution: tuple  # (width, height)
    cam_type: int = PERSPECTIVE
    # the realistic camera's lens: (E, 4) rows (curvature radius, thickness,
    # eta, aperture radius) in meters, front first, and the (64, 4) exit
    # pupil bounds (x0, y0, x1, y1) by film radius, on the device
    lens: Optional[torch.Tensor] = None
    pupil_bounds: Optional[torch.Tensor] = None
    film_diag: float = 0.035
    simple_weighting: bool = True
    # camera motion: the two shutter ends' (T (3,), q (4,), S (3, 3)) on the
    # device, or () when the camera is static
    anim: tuple = ()
    # a realistic camera's L1 launch constants, built from the fields above
    # when the camera is made (dataclasses.replace builds them anew)
    lens_consts: Optional[lens_kernel.LensConsts] = field(init=False, default=None)
    # the importance functions' inverses of cam_to_world and
    # raster_to_camera (f32, inverted in f64 on the host) and the image
    # plane's area at z = 1, built when the camera is made
    world_to_cam: torch.Tensor = field(init=False, default=None)
    camera_to_raster: torch.Tensor = field(init=False, default=None)
    image_area: float = field(init=False, default=0.0)

    def __post_init__(self):
        if self.cam_type == REALISTIC:
            self.lens_consts = lens_kernel.lens_consts(self)
        inv = lambda m: torch.tensor(np.linalg.inv(m.detach().cpu().double().numpy()),
                                     dtype=torch.float32, device=m.device)
        self.world_to_cam = inv(self.cam_to_world)
        self.camera_to_raster = inv(self.raster_to_camera)
        self.image_area = _image_plane_area(self)

    @property
    def device(self) -> torch.device:
        return self.cam_to_world.device


def _screen_window(resolution, frame_aspect=None, screen_window=None):
    sx, sy = resolution
    frame = frame_aspect if frame_aspect is not None else sx / sy
    if screen_window is not None:
        x0, x1, y0, y1 = screen_window
    elif frame > 1.0:
        x0, x1, y0, y1 = -frame, frame, -1.0, 1.0
    else:
        x0, x1, y0, y1 = -1.0, 1.0, -1.0 / frame, 1.0 / frame
    return x0, x1, y0, y1


def _screen_to_raster(resolution, window):
    x0, x1, y0, y1 = window
    sx, sy = resolution
    s1 = tr.scale(sx, sy, 1.0)
    s2 = tr.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
    t = tr.translate([-x0, -y1, 0.0])
    return tr.compose(s1, tr.compose(s2, t))


def _anim_tuple(cam_to_world: tr.Transform, cam_to_world_end: Optional[tr.Transform]):
    """The JAX Camera's anim field: both ends decomposed, each part a tuple
    of floats; () without an end transform."""
    if cam_to_world_end is None:
        return ()
    a = anim.decompose(np.asarray(cam_to_world.m))
    b = anim.decompose(np.asarray(cam_to_world_end.m))
    tt = lambda x: tuple(np.asarray(x).ravel().tolist())
    return (tuple(map(tt, a)), tuple(map(tt, b)))


def _projective(cam_to_screen, resolution, frame_aspect, screen_window):
    """raster_to_camera of a projective camera."""
    s2r = _screen_to_raster(resolution, _screen_window(resolution, frame_aspect, screen_window))
    return tr.compose(tr.inverse(cam_to_screen), tr.inverse(s2r)).m


def make_perspective(cam_to_world: tr.Transform, resolution, fov=90.0, lens_radius=0.0,
                     focal_distance=1e6, shutter_open=0.0, shutter_close=1.0, frame_aspect=None,
                     screen_window=None, cam_to_world_end: Optional[tr.Transform] = None,
                     clipping_start=0.0, device="cuda") -> Camera:
    """Perspective camera (perspective.rs:46-135); cam_to_world_end gives
    shutter motion blur (AnimatedTransform, transform.rs:894)."""
    return camera_from_numpy(dict(
        cam_to_world=cam_to_world.m,
        raster_to_camera=_projective(tr.perspective(fov, 1e-2, 1000.0), resolution,
                                     frame_aspect, screen_window),
        lens_radius=lens_radius, focal_distance=focal_distance, shutter_open=shutter_open,
        shutter_close=shutter_close, cam_type=PERSPECTIVE, resolution=resolution,
        anim=_anim_tuple(cam_to_world, cam_to_world_end), clipping_start=clipping_start,
    ), device)


def make_orthographic(cam_to_world: tr.Transform, resolution, lens_radius=0.0,
                      focal_distance=1e6, shutter_open=0.0, shutter_close=1.0, frame_aspect=None,
                      screen_window=None, device="cuda") -> Camera:
    """Orthographic camera (orthographic.rs).  A moving one comes through
    camera_from_numpy's anim field, as in the JAX package."""
    return camera_from_numpy(dict(
        cam_to_world=cam_to_world.m,
        raster_to_camera=_projective(tr.orthographic(0.0, 1.0), resolution,
                                     frame_aspect, screen_window),
        lens_radius=lens_radius, focal_distance=focal_distance, shutter_open=shutter_open,
        shutter_close=shutter_close, cam_type=ORTHOGRAPHIC, resolution=resolution,
    ), device)


def make_realistic(cam_to_world: tr.Transform, resolution, lens_data, aperture_diameter=1.0,
                   focus_distance=10.0, film_diag_mm=35.0, simple_weighting=True,
                   shutter_open=0.0, shutter_close=1.0, device="cuda") -> Camera:
    """Lens-system camera (realistic.rs:50-197).  lens_data: flat rows of
    (radius, thickness, eta, aperture diameter) in mm, scene side first (a
    pbrt lens file's contents).  Focusing and the exit pupil's bounds are
    computed here, on the host (models/realistic.py)."""
    from . import realistic as rl

    resolve(device)  # before the host's work: no card, no camera
    elements = rl.parse_lens_data(lens_data, aperture_diameter)
    film_diag = film_diag_mm * 0.001
    elements[-1, 1] = rl.focus_thick_lens(elements, focus_distance, film_diag)
    pupil = rl.build_exit_pupil_bounds(elements, film_diag)
    return camera_from_numpy(dict(
        cam_to_world=cam_to_world.m, raster_to_camera=np.eye(4, dtype=np.float32),
        lens_radius=0.0, focal_distance=focus_distance, shutter_open=shutter_open,
        shutter_close=shutter_close, cam_type=REALISTIC, resolution=resolution,
        lens=elements.astype(np.float32), pupil_bounds=pupil, film_diag=film_diag,
        simple_weighting=simple_weighting,
    ), device)


def make_environment(cam_to_world: tr.Transform, resolution, shutter_open=0.0, shutter_close=1.0,
                     device="cuda") -> Camera:
    """Environment camera (environment.rs): every direction, by latitude
    and longitude over the film."""
    return camera_from_numpy(dict(
        cam_to_world=cam_to_world.m, raster_to_camera=np.eye(4, dtype=np.float32),
        lens_radius=0.0, focal_distance=1e6, shutter_open=shutter_open,
        shutter_close=shutter_close, cam_type=ENVIRONMENT, resolution=resolution,
    ), device)


def camera_from_numpy(fields: Mapping, device="cuda") -> Camera:
    """Camera from the JAX package's Camera fields (numpy arrays, scalars
    and tuples), every type, with or without motion.  Near clipping
    (clipping_start > 0) raises."""
    if float(fields.get("clipping_start", 0.0)) > 0.0:
        raise NotImplementedError("near clipping (clipping_start) comes with the .blend "
                                  "importer (ROADMAP A18)")
    cam_type = int(fields.get("cam_type", PERSPECTIVE))
    if cam_type not in (PERSPECTIVE, ORTHOGRAPHIC, ENVIRONMENT, REALISTIC):
        raise ValueError(f"unknown camera type {cam_type}")
    dev = resolve(device)

    def f32(x):
        return np.asarray(x, np.float32)

    lens = pupil = None
    if cam_type == REALISTIC:
        lens = torch.tensor(f32(fields["lens"]).reshape(-1, 4), device=dev)
        pupil = torch.tensor(f32(fields["pupil_bounds"]), device=dev)
    parts = ()
    if fields.get("anim"):
        (T0, q0, S0), (T1, q1, S1) = fields["anim"]
        parts = tuple(torch.tensor(f32(x), device=dev).reshape(shape) for x, shape in (
            (T0, (3,)), (q0, (4,)), (S0, (3, 3)), (T1, (3,)), (q1, (4,)), (S1, (3, 3))))
    return Camera(
        cam_to_world=torch.tensor(f32(fields["cam_to_world"]), device=dev),
        raster_to_camera=torch.tensor(f32(fields["raster_to_camera"]), device=dev),
        # the JAX Camera's f32 scalars
        lens_radius=float(np.float32(fields["lens_radius"])),
        focal_distance=float(np.float32(fields["focal_distance"])),
        shutter_open=float(np.float32(fields["shutter_open"])),
        shutter_close=float(np.float32(fields["shutter_close"])),
        resolution=tuple(int(r) for r in fields["resolution"]),
        cam_type=cam_type, lens=lens, pupil_bounds=pupil,
        film_diag=float(fields.get("film_diag", 0.035)),
        simple_weighting=bool(fields.get("simple_weighting", True)),
        anim=parts,
    )


class CameraRays(NamedTuple):
    o: torch.Tensor  # (N,3)
    d: torch.Tensor  # (N,3)
    time: torch.Tensor  # (N,)
    weight: torch.Tensor  # (N,) importance weight (the realistic camera's vignetting)


def generate_rays(cam: Camera, p_film, u_lens, u_time) -> CameraRays:
    """p_film: (N,2) raster points; u_lens: (N,2); u_time: (N,)
    (camera.rs:28 dispatch).  Motion interpolates the camera at u_time (as
    the JAX package does), for the perspective and orthographic cameras."""
    n = p_film.shape[0]
    time = (1.0 - u_time) * cam.shutter_open + u_time * cam.shutter_close
    if cam.cam_type == REALISTIC:
        o, d, w = lens_kernel.lens_rays(cam, p_film.contiguous(), u_lens.contiguous())
        return CameraRays(o, d, time, w)
    ones = torch.ones_like(u_time)
    if cam.cam_type == ENVIRONMENT:
        sx, sy = cam.resolution
        theta = float(PI) * p_film[:, 1] / sy
        phi = 2.0 * float(PI) * p_film[:, 0] / sx
        d_cam = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                             torch.sin(theta) * torch.sin(phi)], -1)
        o = cam.cam_to_world[:3, 3].expand(n, 3).contiguous()
        return CameraRays(o, tr.xform_vector(cam.cam_to_world, d_cam), time, ones)
    p_cam = tr.xform_point(cam.raster_to_camera,
                           torch.cat([p_film, p_film.new_zeros((n, 1))], -1))
    if cam.cam_type == PERSPECTIVE:
        o_cam = torch.zeros_like(p_cam)
        d_cam = normalize(p_cam)
    else:  # ORTHOGRAPHIC
        o_cam = p_cam
        d_cam = p_cam.new_tensor([0.0, 0.0, 1.0]).expand(n, 3)
    if cam.lens_radius > 0.0:  # depth of field (perspective.rs:230-260)
        p_lens = cam.lens_radius * concentric_sample_disk(u_lens)
        ft = cam.focal_distance / torch.clamp(d_cam[..., 2], min=1e-8)
        p_focus = o_cam + ft[..., None] * d_cam
        o_cam = torch.cat([p_lens, p_lens.new_zeros((n, 1))], -1)
        d_cam = normalize(p_focus - o_cam)
    m = anim.interpolate(u_time, *cam.anim) if cam.anim else cam.cam_to_world
    o = tr.xform_point(m, o_cam)
    d = normalize(tr.xform_vector(m, d_cam))
    return CameraRays(o, d, time, ones)


# ---- the importance interface of light transport (camera.rs:36-76,
# perspective.rs we / pdf_we / sample_wi), BDPT's and MLT's ----

def _image_plane_area(cam: Camera) -> float:
    """The image plane's area at z = 1 in camera space (the `a` of
    perspective.rs:114-133), in f32 as the JAX package computes it."""
    sx, sy = cam.resolution
    r2c = cam.raster_to_camera.detach().cpu()
    p_min = tr.xform_point(r2c, torch.tensor([0.0, 0.0, 0.0]))
    p_max = tr.xform_point(r2c, torch.tensor([float(sx), float(sy), 0.0]))
    p_min, p_max = p_min / p_min[2], p_max / p_max[2]
    return float(((p_max[0] - p_min[0]) * (p_max[1] - p_min[1])).abs())


def camera_we(cam: Camera, o, d):
    """(importance We, raster point (N, 2), inside) of rays (o, d) leaving
    the camera: 0 outside the frustum (perspective.rs we)."""
    d_cam = tr.xform_vector(cam.world_to_cam, d)
    cos_theta = d_cam[..., 2]
    p_focus = d_cam / torch.clamp(cos_theta[..., None], min=1e-9)
    p_raster = tr.xform_point(cam.camera_to_raster, p_focus)
    sx, sy = cam.resolution
    inside = ((cos_theta > 0) & (p_raster[..., 0] >= 0) & (p_raster[..., 0] < sx)
              & (p_raster[..., 1] >= 0) & (p_raster[..., 1] < sy))
    cos2 = cos_theta * cos_theta
    we = torch.where(inside, 1.0 / torch.clamp(cam.image_area * cos2 * cos2, min=1e-12), 0.0)
    return we, p_raster[..., :2], inside


def camera_pdf_we(cam: Camera, o, d):
    """(pdf_pos, pdf_dir) with which generate_rays makes the ray (o, d)
    (perspective.rs pdf_we)."""
    _, _, inside = camera_we(cam, o, d)
    cos_theta = tr.xform_vector(cam.world_to_cam, d)[..., 2]
    # cos^3 as x * (x * x), XLA's integer power
    cos3 = cos_theta * (cos_theta * cos_theta)
    pdf_dir = torch.where(inside, 1.0 / torch.clamp(cam.image_area * cos3, min=1e-12), 0.0)
    return torch.ones_like(pdf_dir), pdf_dir


def camera_sample_wi(cam: Camera, ref_p):
    """A direction from ref_p (N, 3) to the pinhole (perspective.rs
    sample_wi, lens area 1): (wi, We, pdf, raster point, the camera's
    position (N, 3))."""
    cam_p = cam.cam_to_world[:3, 3].expand_as(ref_p)
    to_cam = cam_p - ref_p
    dist = torch.sqrt(torch.clamp(vm.length_squared(to_cam), min=1e-20))
    wi = to_cam / dist[..., None]
    cos_theta = tr.xform_vector(cam.world_to_cam, -wi)[..., 2]
    pdf = torch.where(cos_theta > 1e-6, (dist * dist) / torch.clamp(cos_theta, min=1e-6), 0.0)
    we, p_raster, inside = camera_we(cam, cam_p, -wi)
    return wi, torch.where(inside, we, 0.0), pdf, p_raster, cam_p
