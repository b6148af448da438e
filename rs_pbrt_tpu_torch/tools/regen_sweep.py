"""Path regeneration's lane width and a batch's paths, timed on the card.

    python3 rs_pbrt_tpu_torch/tools/regen_sweep.py [--root DIR] [--statue small|full]
        [--spp N] [--widths 14 16 18 20] [--caps 24] [--reps 2]

Renders a statue through render's defaults (the path integrator, depth 5,
regeneration on) with ``regen.REGEN_LANE_WIDTH`` and render's
``max_lanes`` set to each pair given (powers of two), and prints, per
pair, camera paths/s (host clock around the render, synchronized with the
card; best of --reps renders after a warm one), the batches, the
iterations, the wall time an iteration and the peak device memory (scene
and tree included).
"small" is the 1,310,724-triangle statue at 256x256, 8 spp by default;
"full" the 5,242,880-triangle one at 1024x1024, 4 spp by default (its 64
spp at narrow widths take minutes a render).  A width at or above a
batch's paths renders through the fixed-depth loop, as render does.

``--root DIR`` imports ``rs_pbrt_tpu_torch`` from another checkout, to
compare two versions on one card in one call.  Run it as a script (not
with ``-m``) so that ``--root`` decides which package is imported.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

STATUES = {"small": (8, (256, 256), 8), "full": (9, (1024, 1024), 4)}  # subdiv, res, spp
DEPTH = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose rs_pbrt_tpu_torch is timed")
    ap.add_argument("--statue", choices=sorted(STATUES), default="small")
    ap.add_argument("--spp", type=int, default=None, help="samples a pixel (default by statue)")
    ap.add_argument("--widths", type=int, nargs="+", default=[14, 16, 18, 20],
                    help="log2 of the lane widths")
    ap.add_argument("--caps", type=int, nargs="+", default=None,
                    help="log2 of the paths a batch (default: the checkout's render.MAX_LANES)")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import regen
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.scene import bigscene
    from rs_pbrt_tpu_torch.tools.k1_b2_replay import card_name

    if not torch.cuda.is_available():
        raise SystemExit("regen_sweep: no CUDA device")
    card, variant = card_name(), args.root.resolve().name
    subdiv, res, spp = STATUES[args.statue]
    spp = args.spp or spp
    t0 = time.perf_counter()
    scene, camera = bigscene.statue_scene(res, subdiv, device="cuda")
    accel = si.build_accel(scene, device="cuda")
    torch.cuda.synchronize()
    print(f"[regen_sweep] ({variant}) statue {scene.n_tris} triangles, {res[0]}x{res[1]}, {spp} "
          f"spp, depth {DEPTH}: scene and BVH {time.perf_counter() - t0:.3f} s (host) ({card})",
          flush=True)
    cfg = rdr.RenderCfg("path", spp=spp, max_depth=DEPTH, rr_threshold=1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, spp, res)
    caps = [1 << c for c in args.caps] if args.caps else [rdr.MAX_LANES]
    rdr.render(scene, camera, cfg._replace(spp=1), scfg, accel=accel)  # builds the kernels
    for cap in caps:
        for w in args.widths:
            regen.REGEN_LANE_WIDTH = 1 << w
            torch.cuda.reset_peak_memory_stats()
            rdr.render(scene, camera, cfg, scfg, accel=accel, max_lanes=cap)  # warm
            peak = torch.cuda.max_memory_allocated() / 2**30
            best = None
            for _ in range(args.reps):
                st = {}
                rdr.render(scene, camera, cfg, scfg, accel=accel, max_lanes=cap, stats=st)
                best = st if best is None or st["wall_s"] < best["wall_s"] else best
            its = best["iterations"]
            per_it = (f", {1e3 * best['wall_s'] / its:.3f} ms an iteration" if its
                      else " (the fixed-depth loop)")
            print(f"[regen_sweep] ({variant}) cap 2^{cap.bit_length() - 1}, width 2^{w}: "
                  f"{best['paths_per_s']:.6g} camera paths/s ({best['wall_s']:.3f} s), "
                  f"{best['batches']} batches, {its} iterations{per_it}, peak device memory "
                  f"{peak:.2f} GiB ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
