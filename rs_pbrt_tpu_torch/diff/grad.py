"""Differentiable rendering: gradients in the material, light, texture and
camera parameters, by autograd.

The port of the JAX package's ``diff/grad.py``.  Detached sampling: the
path integrator's sampling decisions (BSDF directions and pdfs, light
selection, MIS weights, Russian roulette) are detached
(``models/integrators/path.py``), so for a fixed sample set the radiance
estimator is an a.e.-differentiable function of the leaves, and its
reverse-mode gradient equals a central finite difference on the same
seeds.  The render takes the fixed-depth loop (``regen=False``), never the
bounce kernel K2 (``path_kernel.mega_cfg`` refuses tracked tables), and
its kernels take their backward passes: the closest triangle hit G1, the
texture lookup T2 and the filter splat R2.  A kernel without a backward
raises where a gradient would reach it (``ops/autodiff.py``, ROADMAP
A17c).  Geometry gradients are ``diff/geometry.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve
from ..models import cameras as cam
from ..models.integrators import render as rdr
from ..scene import arrays as sa


class DiffParams(NamedTuple):
    """The differentiable leaves of a Scene (the JAX DiffParams)."""

    mat_params: torch.Tensor  # (M, N_MAT_PARAMS)
    light_emission: torch.Tensor  # (L, 3) emitted radiance or intensity, rgb
    tex_params: torch.Tensor  # (T, N_TEX_PARAMS)
    tex_atlas: torch.Tensor  # (AH, AW, 3) every image's pyramid as stored


class CameraGrads(NamedTuple):
    """The gradient of a loss in the camera's tensor leaves."""

    cam_to_world: torch.Tensor  # (4, 4)
    raster_to_camera: torch.Tensor  # (4, 4)
    lens_radius: torch.Tensor  # ()
    focal_distance: torch.Tensor
    shutter_open: torch.Tensor
    shutter_close: torch.Tensor


def get_params(scene: sa.Scene) -> DiffParams:
    return DiffParams(scene.mat_attr[:, sa.MA_PARAMS:sa.MA_PARAMS + sa.N_MAT_PARAMS],
                      scene.light_attr[:scene.n_lights, sa.LP_I:sa.LP_I + 3],
                      scene.tex_params, scene.tex_atlas)


def diff_params_from_numpy(params, device="cuda") -> DiffParams:
    """DiffParams of numpy arrays (the JAX package's DiffParams, field for
    field, e.g. ``[np.asarray(a) for a in jax_params]``) on device."""
    dev = resolve(device)
    return DiffParams(*(torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in params))


def apply_params(scene: sa.Scene, p: DiffParams) -> sa.Scene:
    """The scene with its packed attribute tables rebuilt from the leaves p,
    out of place, so that gradients reach every reader (the JAX
    apply_params)."""
    ma = scene.mat_attr
    mat_attr = torch.cat([ma[:, :sa.MA_PARAMS], p.mat_params,
                          ma[:, sa.MA_PARAMS + sa.N_MAT_PARAMS:]], 1)
    la, n = scene.light_attr, scene.n_lights
    light_attr = torch.cat([
        torch.cat([la[:n, :sa.LP_I], p.light_emission, la[:n, sa.LP_I + 3:]], 1), la[n:]], 0)
    return dataclasses.replace(scene, mat_attr=mat_attr, light_attr=light_attr,
                               tex_params=p.tex_params, tex_atlas=p.tex_atlas)


def render_image(scene, camera, cfg, sampler_cfg, params: Optional[DiffParams] = None,
                 accel=None, max_lanes: int = rdr.MAX_LANES, filter_cfg=None):
    """The image (H, W, 3) as a function of params (the scene's own where
    None), through the fixed-depth loop (regen=False), as the JAX
    render_image renders it."""
    if params is not None:
        scene = apply_params(scene, params)
    return rdr.render(scene, camera, cfg, sampler_cfg, filter_cfg=filter_cfg, accel=accel,
                      max_lanes=max_lanes, regen=False)


def _leaves(tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def _grads(loss, leaves):
    if not loss.requires_grad:  # a rank of a mesh that renders no pixel
        return [torch.zeros_like(x) for x in leaves]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]


def grad_loss(scene, camera, cfg, sampler_cfg, loss_fn, params: Optional[DiffParams] = None,
              accel=None, mesh=None, filter_cfg=None):
    """(loss, DiffParams of d loss / d params): loss_fn maps the image (H,
    W, 3) to a scalar tensor.  mesh: a DeviceMesh whose every rank calls
    this alike (``parallel/mesh.py``): the forward render is
    ``render_sharded`` (the fixed-depth loop), whose film sum passes the
    image's gradient to each rank's own pixels, and the parameter gradients
    are summed over the mesh, so every rank returns the whole gradient (the
    JAX grad.py:107-113, where the film psum's transpose does that sum)."""
    leaves = _leaves(get_params(scene) if params is None else params)
    with torch.enable_grad():
        if mesh is None:
            img = render_image(scene, camera, cfg, sampler_cfg, DiffParams(*leaves), accel=accel,
                               filter_cfg=filter_cfg)
        else:
            from ..parallel import mesh as pmesh

            img = pmesh.render_sharded(apply_params(scene, DiffParams(*leaves)), camera, cfg,
                                       sampler_cfg, filter_cfg, mesh, accel)
        loss = loss_fn(img)
        grads = _grads(loss, leaves)
    if mesh is not None:
        grads = [pmesh.all_reduce(g.contiguous(), mesh) for g in grads]
    return loss.detach(), DiffParams(*grads)


def grad_loss_wrt_camera(scene, camera: cam.Camera, cfg, sampler_cfg, loss_fn, accel=None):
    """(loss, CameraGrads): the gradient in the camera's cam_to_world and
    raster_to_camera matrices, lens radius, focal distance and shutter
    interval (pose, zoom, defocus and exposure window), by detached
    sampling: the interior term only, as in the JAX package (silhouettes
    are a measure-zero set of the lanes whose visibility the gradient does
    not see)."""
    dev = camera.device
    scalar = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    leaves = _leaves([camera.cam_to_world, camera.raster_to_camera, scalar(camera.lens_radius),
                      scalar(camera.focal_distance), scalar(camera.shutter_open),
                      scalar(camera.shutter_close)])
    with torch.enable_grad():
        cam_p = dataclasses.replace(camera, **dict(zip(CameraGrads._fields, leaves)))
        img = rdr.render(scene, cam_p, cfg, sampler_cfg, accel=accel, regen=False)
        loss = loss_fn(img)
        grads = _grads(loss, leaves)
    return loss.detach(), CameraGrads(*grads)
