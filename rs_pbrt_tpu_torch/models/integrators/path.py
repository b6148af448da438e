"""Path integrator with NEE, MIS and Russian roulette.

The port of the JAX package's ``models/integrators/path.py`` (reference
src/integrators/path.rs:59-281) for the scenes the bounce kernel renders:
all-matte, triangles only, lit by triangle-range area lights, sampled with
Sobol'.  Every bounce is one launch of K2 (``ops/path_kernel.py``).  The
general wavefront bounce, which serves every other scene, is ROADMAP
slice 2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...ops import path_kernel as pk
from ...scene import arrays as sa
from .. import samplers as smpl

# per-bounce sampler dimensions after the camera's 0-4:
#   +0 light select, +1,2 light u, +3,4 bsdf u, +5 bsdf lobe choice, +6 rr
DIMS_PER_BOUNCE = pk.DIMS_PER_BOUNCE
DIM_CAMERA = 5


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
