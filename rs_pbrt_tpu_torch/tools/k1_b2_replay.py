"""K1 and B2 timed on the card alone, on the launches of the renders
``chip_smoke.py`` drives.

    python3 rs_pbrt_tpu_torch/tools/k1_b2_replay.py [--root DIR]

Records the inputs of every K1 launch (``sobol_kernel.sobol_dims``) of
four renders, each in one batch at depth 5 as ``chip_smoke.py`` renders
them: the flagship (the Cornell box, path, 256x256, 64 spp),
``spheres_direct`` with directlighting and with whitted (256x256, 64 spp)
and the 1,310,724-triangle statue (path, 256x256, 8 spp); and of
every B2 launch (``bvh.bvh12_intersect_tris(..., any_hit=True)``) of the
statue.  Each launch is then replayed ``REPS`` times queued behind a
sleeping kernel (``queued_ms``), so that CUDA events time the card alone
and not the host's share of a call; each K1 launch is held bit-equal to
``sobol_dims_plain`` and each B2 launch equal to ``bvh12_intersect_plain``
first.

``--root DIR`` imports ``rs_pbrt_tpu_torch`` from another checkout, to
compare two versions of the kernels on one card.  Each version records its
own launches (the index width and the dims a launch draws are the
version's own).

Run it as a script (not with ``-m``) so that ``--root`` decides which
package is imported.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

RES, SPP, STATUE_SPP, DEPTH, STATUE_SUBDIV = (256, 256), 64, 8, 5, 8
REPS = 20


def queued_ms(fn, reps: int) -> float:
    """Device time of fn() per call: reps calls queued behind a sleeping
    kernel, so that the card runs them back to back and CUDA events around
    them time the card alone.  Events around calls as the host makes them
    time a kernel shorter than the host's cost of a call as that cost.
    Raises if the sleep ended before the host had queued every call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event()
    # cycles at 2 GHz, above the card's clock, so the sleep lasts at least this
    torch.cuda._sleep(int(2e9 * (3 * reps * host_s + 5e-3)))
    slept.record()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if slept.query():
        raise RuntimeError("queued_ms: the card woke before the calls were queued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def record(go, module, name: str, keep=lambda args, kw: True) -> list:
    """(args, kw) of every call of module.name that keep() accepts during
    go(), the calls passed on to the wrapper."""
    calls, real = [], getattr(module, name)

    def rec(*args, **kw):
        if keep(args, kw):
            calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, rec)
    try:
        go()
    finally:
        setattr(module, name, real)
    torch.cuda.synchronize()
    return calls


def renders(device: str = "cuda"):
    """(name, go) of the four renders, each go() rendering once; the
    statue's scene and tree are built here."""
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.scene import bigscene, presets

    def render(scene, camera, integrator, spp, accel=None):
        cfg = rdr.RenderCfg(integrator, spp=spp, max_depth=DEPTH, rr_threshold=1.0)
        scfg = smpl.make_sampler(smpl.SOBOL, spp, RES)
        return lambda: rdr.render(scene, camera, cfg, scfg, accel=accel,
                                  max_lanes=RES[0] * RES[1] * spp)

    statue, s_camera = bigscene.statue_scene(RES, STATUE_SUBDIV, device=device)
    return [("flagship", render(*presets.cornell_box(RES, device=device), "path", SPP)),
            *((name, render(*presets.spheres_direct(RES, device=device), name, SPP))
              for name in ("directlighting", "whitted")),
            ("statue", render(statue, s_camera, "path", STATUE_SPP,
                              si.build_accel(statue, device=device)))]


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose rs_pbrt_tpu_torch is timed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    from rs_pbrt_tpu_torch.ops import bvh
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk

    variant = args.root.resolve().name
    card = card_name()
    k1_all, b2_all = [], []
    for name, go in renders():
        go()  # warm: builds the kernels, fills the caches
        k1 = record(go, sk, "sobol_dims")
        ms = []
        for (a, kw) in k1:
            if not torch.equal(sk.sobol_dims(*a, **kw), sk.sobol_dims_plain(*a, **kw)):
                raise AssertionError(f"{name}: K1 differs from sobol_dims_plain on {a[1:]}")
            ms.append(queued_ms(lambda a=a, kw=kw: sk.sobol_dims(*a, **kw), REPS))
        k1_all += ms
        shapes = [(a[0].shape[0], *a[2:]) for a, _ in k1]
        print(f"[k1_b2_replay] {name} ({variant}): K1 {len(ms)} launches "
              f"{', '.join(f'{t:.4f}' for t in ms)} ms = {sum(ms):.4f} ms on the card, bit-equal "
              f"to the plain version; (lanes, dims, bits) {shapes} ({card})", flush=True)
        if name == "statue":
            b2 = record(go, bvh, "bvh12_intersect_tris", lambda a, kw: kw.get("any_hit", False))
            ms = []
            for a, kw in b2:
                if not torch.equal(bvh.bvh12_intersect_tris(*a, **kw),
                                   bvh.bvh12_intersect_plain(*a, **kw).valid):
                    raise AssertionError("statue: B2 differs from bvh12_intersect_plain")
                ms.append(queued_ms(lambda a=a, kw=kw: bvh.bvh12_intersect_tris(*a, **kw),
                                    REPS // 2))
            b2_all += ms
            print(f"[k1_b2_replay] statue ({variant}): B2 {len(ms)} launches "
                  f"{', '.join(f'{t:.4f}' for t in ms)} ms = {sum(ms):.4f} ms on the card, equal "
                  f"to the plain version; rays {[a[0].shape[0] for a, _ in b2]} ({card})",
                  flush=True)
    print(f"[k1_b2_replay] ({variant}) K1 all {len(k1_all)} launches {sum(k1_all):.4f} ms, "
          f"B2 all {len(b2_all)} launches {sum(b2_all):.4f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
