"""K2 (``ops/path_kernel.bounce``) timed on the launches of two renders.

    python3 rs_pbrt_tpu_torch/tools/k2_replay.py [--root DIR] [--one-hot] [--table shared|device]

Records the inputs of every K2 launch of two path-integrator renders at
depth 5, in one batch each: the flagship, the Cornell box at 256x256 and
64 spp (six launches of 4,194,304 lanes), and ``curtain_scene``, the
Cornell box's walls and light with a wavy curtain of 2,016 triangles, 2,028
in all, near the largest table K2 takes (``MEGA_MAX_TRIS``), at 256x256 and
4 spp.  Each launch is then replayed on copies of its inputs and timed by
CUDA events (the best of 5 after a warm call), and the curtain's launches
are held against ``bounce_plain``.

- ``--root DIR`` imports ``rs_pbrt_tpu_torch`` from another checkout, to
  compare two versions of the kernel on one card.
- ``--one-hot`` gives the sweeps the one-hot shear form on every table.
- ``--table shared|device`` puts every table's vertices in shared memory,
  or leaves every table in device memory (``SHARED_TABLE_MAX_TRIS``).

Run it as a script (not with ``-m``) so that ``--root`` decides which
package is imported.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

RES, FLAGSHIP_SPP, CURTAIN_SPP, DEPTH = (256, 256), 64, 4, 5
CURTAIN_GRID = (36, 28)  # quads across x and y: 2,016 triangles
REPS = 5


def curtain_scene(resolution=RES, device="cuda"):
    """The Cornell box's five walls and ceiling light (presets.cornell_box,
    without the blocks) and a matte curtain of CURTAIN_GRID quads hung in
    front of the back wall, its depth a product of sines.  Returns (scene,
    camera); the bounce kernel takes the scene (path_kernel.mega_cfg)."""
    from rs_pbrt_tpu_torch.models import cameras as cam
    from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
    from rs_pbrt_tpu_torch.utils import transform as tr

    b = SceneBuilder()
    white = b.add_matte(kd=(0.73, 0.73, 0.73))
    red = b.add_matte(kd=(0.65, 0.05, 0.05))
    green = b.add_matte(kd=(0.12, 0.45, 0.15))
    cloth = b.add_matte(kd=(0.25, 0.3, 0.6))
    light_mat = b.add_matte(kd=(0.0, 0.0, 0.0))
    quad = lambda pts, mat, light=None: b.add_triangle_mesh(
        [[0, 1, 2], [0, 2, 3]], np.asarray(pts, np.float32), material=mat, area_light=light)
    quad([[552.8, 0, 0], [0, 0, 0], [0, 0, 559.2], [549.6, 0, 559.2]], white)
    quad([[556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2], [0, 548.8, 0]], white)
    quad([[549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2], [556, 548.8, 559.2]], white)
    quad([[556, 0, 0], [556, 0, 559.2], [556, 548.8, 559.2], [556, 548.8, 0]], green)
    quad([[0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2]], red)
    quad([[343, 548.75, 227], [343, 548.75, 332], [213, 548.75, 332], [213, 548.75, 227]],
         light_mat, dict(L=(50.0, 50.0, 50.0), two_sided=False))

    nx, ny = CURTAIN_GRID
    u, v = np.meshgrid(np.linspace(0.0, 1.0, nx + 1), np.linspace(0.0, 1.0, ny + 1))
    pos = np.stack([60.0 + 440.0 * u, 20.0 + 500.0 * v,
                    470.0 + 60.0 * np.sin(6 * np.pi * u) * np.sin(2 * np.pi * v)], -1)
    k = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
    c00, c10, c11, c01 = k[:-1, :-1], k[:-1, 1:], k[1:, 1:], k[1:, :-1]
    tris = np.concatenate([np.stack([c00, c10, c11], -1).reshape(-1, 3),
                           np.stack([c00, c11, c01], -1).reshape(-1, 3)])
    b.add_triangle_mesh(tris, pos.reshape(-1, 3).astype(np.float32), material=cloth)

    scene = b.finalize(device)
    camera = cam.make_perspective(
        tr.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]), resolution, fov=39.3077,
        device=device)
    return scene, camera


def record_launches(scene, camera, spp: int, depth: int = DEPTH) -> list:
    """(lanes, alive, index, tables, cfg, kw) of every K2 launch of one
    path render of `scene` in one batch, the lane state copied before each
    launch."""
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import path_kernel as pk

    calls, real = [], pk.bounce

    def keep(lanes, alive, index, tables, cfg, **kw):
        calls.append((lanes.clone(), alive.clone(), index, tables, cfg, kw))
        return real(lanes, alive, index, tables, cfg, **kw)

    w, h = camera.resolution
    cfg = rdr.RenderCfg("path", spp=spp, max_depth=depth, rr_threshold=1.0)
    pk.bounce = keep
    try:
        rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, spp, (w, h)),
                   max_lanes=w * h * spp)
    finally:
        pk.bounce = real
    return calls


def replay_ms(call, reps: int = REPS) -> float:
    """Best time of one recorded launch over `reps` replays on fresh copies
    of its lane state, after a warm one: CUDA events around the wrapper call
    on the card, the host clock on the CPU."""
    from rs_pbrt_tpu_torch.ops import path_kernel as pk

    lanes, alive, index, tables, cfg, kw = call
    cuda = lanes.device.type == "cuda"
    best = float("inf")
    for rep in range(reps + 1):
        ln, al = lanes.clone(), alive.clone()
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            pk.bounce(ln, al, index, tables, cfg, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1])
        else:
            t0 = time.perf_counter()
            pk.bounce(ln, al, index, tables, cfg, **kw)
            ms = 1e3 * (time.perf_counter() - t0)
        if rep:
            best = min(best, ms)
    return best


def check_launch(call, tol: float = 2e-3) -> float:
    """One recorded launch through the wrapper against bounce_plain on the
    same inputs: alive equal and all 13 rows finite and within tol (rtol =
    atol).  Returns the largest absolute difference; raises on a mismatch."""
    from rs_pbrt_tpu_torch.ops import path_kernel as pk

    lanes, alive, index, tables, cfg, kw = call
    want = pk.bounce_plain(lanes, alive, index, tables, cfg, **kw)
    got = pk.bounce(lanes.clone(), alive.clone(), index, tables, cfg, **kw)
    bad = int((got[1] != want[1]).sum())
    err = float((got[0] - want[0]).abs().max())
    if bad or not torch.isfinite(got[0]).all() or not torch.allclose(got[0], want[0], rtol=tol,
                                                                      atol=tol):
        raise AssertionError(f"K2 differs from bounce_plain: {bad} lanes' alive, rows by {err}")
    return err


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose rs_pbrt_tpu_torch is timed")
    ap.add_argument("--one-hot", action="store_true", help="the sweeps' one-hot shear form")
    ap.add_argument("--table", choices=("shared", "device"),
                    help="every table's vertices in shared memory, or none")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.scene import presets

    if args.table:
        pk.SHARED_TABLE_MAX_TRIS = pk.MEGA_MAX_TRIS if args.table == "shared" else 0
    variant = f"{args.root.resolve().name}, {'one-hot' if args.one_hot else 'default'} form, " \
              f"{args.table or 'default'} table"
    card = card_name()
    for name, (scene, camera), spp in (
            ("flagship", presets.cornell_box(RES, device="cuda"), FLAGSHIP_SPP),
            ("curtain", curtain_scene(RES, device="cuda"), CURTAIN_SPP)):
        calls = record_launches(scene, camera, spp)
        if args.one_hot:
            calls = [c[:3] + (c[3]._replace(finite_verts=False),) + c[4:] for c in calls]
        if name == "curtain":
            errs = [check_launch(c) for c in calls]
            print(f"[k2_replay] curtain ({scene.n_tris} triangles): every launch within 2e-3 "
                  f"of bounce_plain (max abs err {max(errs):.3g}), alive equal", flush=True)
        ms = [replay_ms(c) for c in calls]
        live = [int(c[1].sum()) for c in calls]
        print(f"[k2_replay] {name} ({variant}): {len(ms)} launches "
              f"{', '.join(f'{t:.4f}' for t in ms)} ms = {sum(ms):.4f} ms; live lanes "
              f"{live} ({card})", flush=True)
        del calls
    return 0


if __name__ == "__main__":
    sys.exit(main())
