"""Path integrator with NEE, MIS and Russian roulette.

The port of the JAX package's ``models/integrators/path.py`` (reference
src/integrators/path.rs:59-281) for the scenes the bounce kernel renders:
all-matte, triangles only, lit by triangle-range area lights, sampled with
Sobol'.  Every bounce is one launch of K2 (``ops/path_kernel.py``).  The
general wavefront bounce, which serves every other scene, is not ported
yet (ROADMAP queue A); the shading-frame helpers that the direct-lighting
integrators share with it are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...ops import path_kernel as pk
from ...ops import sampling as smp
from ...scene import arrays as sa
from ...utils import vecmath as vm
from .. import samplers as smpl

# per-bounce sampler dimensions after the camera's 0-4:
#   +0 light select, +1,2 light u, +3,4 bsdf u, +5 bsdf lobe choice, +6 rr
DIMS_PER_BOUNCE = pk.DIMS_PER_BOUNCE
DIM_CAMERA = 5


def _shading_frame_du(ns, dpdu):
    """BSDF frame with its x axis along the surface u-tangent
    (reflection.rs Bsdf::new: ss = normalize(dpdu)), orthogonalized against
    ns; an arbitrary frame where dpdu is degenerate.  Returns (ss, ts)."""
    ss = dpdu - ns * vm.dot(ns, dpdu)[..., None]
    degen = (vm.length_squared(ss) < 1e-14)[..., None]
    ss_fb, _ = vm.coordinate_system(ns)
    ss = torch.where(degen, ss_fb, vm.normalize(torch.where(degen, ss_fb, ss)))
    return ss, vm.cross(ns, ss)


def _to_local(v, ss, ts, ns):
    return torch.stack([vm.dot(v, ss), vm.dot(v, ts), vm.dot(v, ns)], -1)


def _to_world(v, ss, ts, ns):
    return v[..., 0:1] * ss + v[..., 1:2] * ts + v[..., 2:3] * ns


def _light_select_dist(scene: sa.Scene) -> smp.Distribution1D:
    """Light selection by power (integrator.rs:574)."""
    return smp.make_distribution_1d(scene.light_power)


class PathCfg(NamedTuple):
    max_depth: int  # reference default 5 (api.rs:248)
    rr_threshold: float  # Russian roulette after bounce 3 (path.rs:254)


def radiance(scene: sa.Scene, cfg: PathCfg, sampler_cfg: smpl.SamplerCfg,
             ctx: smpl.SampleCtx, ray_o: torch.Tensor, ray_d: torch.Tensor,
             mega: Optional[pk.MegaCfg] = None) -> torch.Tensor:
    """(N, 3) radiance along N camera rays.  Light selection is by power.
    mega: the scene's MegaCfg when the caller has it already."""
    if mega is None:
        mega = pk.mega_cfg(scene)
    if mega is None:
        raise NotImplementedError(
            "this scene needs the general path bounce, which is not ported yet "
            "(ROADMAP slice 2); the port renders all-matte triangle scenes lit by "
            "triangle area lights")
    if sampler_cfg.kind != smpl.SOBOL:
        raise NotImplementedError("the path integrator is ported for the Sobol' sampler only")
    return pk.mega_radiance(scene, mega, cfg.max_depth, cfg.rr_threshold, ctx.global_index,
                            smpl.index_bits(sampler_cfg), DIM_CAMERA, ray_o, ray_d)
