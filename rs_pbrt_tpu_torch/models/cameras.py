"""The perspective camera as a batched ray generator.

The port of the perspective parts of the JAX package's
``models/cameras.py`` (reference cameras/perspective.rs).  The other
camera types and camera motion raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..device import resolve
from ..ops.sampling import concentric_sample_disk
from ..utils import transform as tr
from ..utils.vecmath import normalize

PERSPECTIVE = 0  # the JAX package's camera type tag


@dataclass
class Camera:
    cam_to_world: torch.Tensor  # (4,4)
    raster_to_camera: torch.Tensor  # (4,4)
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    resolution: tuple  # (width, height)

    @property
    def device(self) -> torch.device:
        return self.cam_to_world.device


def _screen_window(resolution):
    sx, sy = resolution
    frame = sx / sy
    if frame > 1.0:
        return -frame, frame, -1.0, 1.0
    return -1.0, 1.0, -1.0 / frame, 1.0 / frame


def _screen_to_raster(resolution, window):
    x0, x1, y0, y1 = window
    sx, sy = resolution
    s1 = tr.scale(sx, sy, 1.0)
    s2 = tr.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
    t = tr.translate([-x0, -y1, 0.0])
    return tr.compose(s1, tr.compose(s2, t))


def make_perspective(cam_to_world: tr.Transform, resolution, fov=90.0, lens_radius=0.0,
                     focal_distance=1e6, device="cuda") -> Camera:
    """Perspective camera (perspective.rs:46-135), shutter open over [0, 1]."""
    cam_to_screen = tr.perspective(fov, 1e-2, 1000.0)
    s2r = _screen_to_raster(resolution, _screen_window(resolution))
    raster_to_camera = tr.compose(tr.inverse(cam_to_screen), tr.inverse(s2r))
    return camera_from_numpy(dict(
        cam_to_world=cam_to_world.m, raster_to_camera=raster_to_camera.m,
        lens_radius=lens_radius, focal_distance=focal_distance,
        shutter_open=0.0, shutter_close=1.0, resolution=resolution,
    ), device)


def camera_from_numpy(fields: Mapping, device="cuda") -> Camera:
    """Camera from the JAX package's Camera fields (numpy arrays and
    scalars); perspective, without motion or near clipping."""
    if int(fields.get("cam_type", PERSPECTIVE)) != PERSPECTIVE:
        raise NotImplementedError("only the perspective camera is ported (ROADMAP slice 4)")
    if fields.get("anim") or float(fields.get("clipping_start", 0.0)) > 0.0:
        raise NotImplementedError("camera motion and near clipping are not ported (ROADMAP slice 4)")
    dev = resolve(device)

    def mat(k):
        return torch.tensor(np.asarray(fields[k], np.float32), device=dev)

    return Camera(
        cam_to_world=mat("cam_to_world"),
        raster_to_camera=mat("raster_to_camera"),
        lens_radius=float(fields["lens_radius"]),
        focal_distance=float(fields["focal_distance"]),
        shutter_open=float(fields["shutter_open"]),
        shutter_close=float(fields["shutter_close"]),
        resolution=tuple(int(r) for r in fields["resolution"]),
    )


class CameraRays(NamedTuple):
    o: torch.Tensor  # (N,3)
    d: torch.Tensor  # (N,3)
    time: torch.Tensor  # (N,)
    weight: torch.Tensor  # (N,)


def generate_rays(cam: Camera, p_film, u_lens, u_time) -> CameraRays:
    """p_film: (N,2) raster points; u_lens: (N,2); u_time: (N,)."""
    n = p_film.shape[0]
    time = (1.0 - u_time) * cam.shutter_open + u_time * cam.shutter_close
    p_cam = tr.xform_point(cam.raster_to_camera,
                           torch.cat([p_film, p_film.new_zeros((n, 1))], -1))
    o_cam = torch.zeros_like(p_cam)
    d_cam = normalize(p_cam)
    if cam.lens_radius > 0.0:  # depth of field (perspective.rs:230-260)
        p_lens = cam.lens_radius * concentric_sample_disk(u_lens)
        ft = cam.focal_distance / torch.clamp(d_cam[..., 2], min=1e-8)
        p_focus = o_cam + ft[..., None] * d_cam
        o_cam = torch.cat([p_lens, p_lens.new_zeros((n, 1))], -1)
        d_cam = normalize(p_focus - o_cam)
    o = tr.xform_point(cam.cam_to_world, o_cam)
    d = normalize(tr.xform_vector(cam.cam_to_world, d_cam))
    return CameraRays(o, d, time, torch.ones_like(u_time))
