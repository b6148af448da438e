"""The torch ops a render dispatches, counted on the CPU.

    python3 rs_pbrt_tpu_torch/tools/op_count.py [--root DIR]

Renders each of the earlier slices' scenes at 8x8 on the CPU (the Cornell
box, spheres_direct, caustic_only with smooth and with rough glass,
caustic_hair, hair_patch; depth 5, 2 spp, SPPM one iteration) and prints,
per render, the aten ops it dispatched (a TorchDispatchMode counts them)
and the image's sum.  Host-bound renders pay for each op, so the count is
the BSDF layer's metric of PERF.md section 3; the sum shows that two
versions computed the same image.

``--root DIR`` imports ``rs_pbrt_tpu_torch`` from another checkout, to
compare two versions.  Run it as a script (not with ``-m``) so that
``--root`` decides which package is imported.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

RES = (8, 8)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _rough(scene):
    """The scene with its glass made rough (roughness 0.2 both ways)."""
    from rs_pbrt_tpu_torch.scene import arrays as sa

    glass = torch.round(scene.mat_attr[:, sa.MA_TYPE]) == sa.GLASS
    for col in (sa.MP_ROUGH_U, sa.MP_ROUGH_V):
        scene.mat_attr[glass, sa.MA_PARAMS + col] = 0.2
    scene.has_rough_glass = True
    return scene


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose rs_pbrt_tpu_torch is counted")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.scene import presets
    from rs_pbrt_tpu_torch.tools import caustic_scenes, hair_scenes

    torch.set_num_threads(2)
    runs = [("cornell_box", lambda: presets.cornell_box(RES, device="cpu"), ("path",)),
            ("spheres_direct", lambda: presets.spheres_direct(RES, device="cpu"),
             ("path", "directlighting")),
            ("caustic_only", lambda: caustic_scenes.caustic_only(RES, device="cpu"),
             ("path", "sppm")),
            ("caustic_only, rough glass",
             lambda: (lambda s, c: (_rough(s), c))(*caustic_scenes.caustic_only(RES, device="cpu")),
             ("path",)),
            ("caustic_hair", lambda: caustic_scenes.caustic_hair(RES, device="cpu"), ("path",)),
            ("hair_patch", lambda: hair_scenes.hair_patch(RES, device="cpu"), ("path",))]
    for name, make, integrators in runs:
        scene, camera = make()
        for integrator in integrators:
            sppm = integrator == "sppm"
            cfg = rdr.RenderCfg(integrator, 2, 5, 1.0,
                                extra=dict(n_iterations=1) if sppm else None)
            scfg = smpl.make_sampler(smpl.SOBOL, 1 if sppm else 2, RES)
            with _Count() as count:
                img = rdr.render(scene, camera, cfg, scfg)
            print(f"{name} {integrator}: {sum(count.ops.values())} ops, image sum "
                  f"{float(img.sum())!r}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
