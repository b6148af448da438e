"""K3, K4 and K5 timed on the card alone, on the launches ``chip_smoke.py``
drives.

    python3 rs_pbrt_tpu_torch/tools/sweep_replay.py [--root DIR]

Records the inputs of every K4 and K5 launch (``intersect_kernel.any_sweep``
and ``full_sweep``) of the two slice 2 renders, ``spheres_direct`` at
256x256, 64 spp, depth 5 in one batch, with directlighting and with
whitted, as ``chip_smoke.py`` renders them; then takes the inputs of its
phase 6 (``sweep_inputs``): the ``spheres_direct`` camera rays against its 4
triangles, 262,144 random rays against 2,048 random triangles, and the same
rays against a 300-row table (a chunk of 256 rows and a tail of 44) with
three rows that hold an infinite vertex and one a NaN vertex, swept whole
and without its NaN row, and against a 40-row table (one chunk) with three
rows that hold an infinite vertex.  Each launch is held to its plain version (K4
equal, K3 and K5 ids equal and their rows within rtol = atol = 2e-3), then
replayed ``REPS`` times queued behind a sleeping kernel
(``k1_b2_replay.queued_ms``), so that CUDA events time the card alone and
not the host's share of a call.

``--root DIR`` imports ``rs_pbrt_tpu_torch`` from another checkout, to
compare two versions of the kernels on one card.

Run it as a script (not with ``-m``) so that ``--root`` decides which
package is imported.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

RES, SPP, DEPTH = (256, 256), 64, 5
SWEEP_RAYS, SWEEP_TRIS = 1 << 18, 2048  # the random input
# the mixed table: a chunk of the K3/K4 kernels (256 rows) and a tail of 44;
# rows with an infinite vertex (row, column, value) all in a z column, so
# that the rays whose dominant axis is z meet it in the sheared form; the
# NaN row last
MIXED_TRIS = 300
INF_ROWS = ((20, 2, np.inf), (150, 5, -np.inf), (290, 8, np.inf))
NAN_ROW = (MIXED_TRIS - 1, 4, np.nan)
# and a table of one chunk (the render paths' kernels) with such rows
SMALL_TRIS, SMALL_INF_ROWS = 40, ((5, 2, np.inf), (21, 5, -np.inf), (33, 8, np.inf))
TOL = 2e-3
REPS = 20


def random_rays(n_rays: int, seed: int, device: str):
    """(o, d, t_max): origins in the box [-2.5, 2.5]^3, random directions, a
    fifth of the rays ending at t = 2.5 and the rest at FLT_MAX, the first
    16 of zero direction."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16] = 0.0
    t_max = np.where(rng.uniform(size=n_rays) < 0.2, 2.5, np.finfo(np.float32).max)
    return tuple(torch.tensor(np.asarray(a, np.float32), device=device) for a in (o, d, t_max))


def random_table(n_tri: int, seed: int, device: str, bad=()):
    """A tri_attr table of random triangles in [-2, 2]^3, a third with
    vertex normals, random uv, materials and lights, a fifth reversed
    (tests/test_pallas.py:28-37); bad: (row, column, value) entries set
    after."""
    from rs_pbrt_tpu_torch.scene import arrays as sa

    rng = np.random.default_rng(seed)
    tab = np.zeros((n_tri, sa.N_TRI_ATTR))
    tab[:, sa.TA_P0:sa.TA_P0 + 9] = rng.uniform(-2.0, 2.0, (n_tri, 9))
    has_n = rng.uniform(size=n_tri) < 1 / 3
    tab[:, sa.TA_N0:sa.TA_N0 + 9] = np.where(has_n[:, None], rng.normal(size=(n_tri, 9)), 0.0)
    tab[:, sa.TA_UV0:sa.TA_UV0 + 6] = rng.uniform(size=(n_tri, 6))
    tab[:, sa.TA_HAS_N] = has_n
    tab[:, sa.TA_MAT] = rng.integers(0, 4, n_tri)
    tab[:, sa.TA_LIGHT] = np.where(rng.uniform(size=n_tri) < 0.1, rng.integers(0, 3, n_tri), -1)
    tab[:, sa.TA_REVERSE] = rng.uniform(size=n_tri) < 0.2
    tab[:, sa.TA_MED_IN:] = -1.0
    for row, col, value in bad:
        tab[row, col] = value
    return torch.tensor(np.asarray(tab, np.float32), device=device)


def sweep_inputs(device: str = "cuda") -> dict:
    """chip_smoke.py's phase 6 inputs, name -> (o, d, t_max, table, n_tri)."""
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.scene import presets

    scene, camera = presets.spheres_direct(RES, device=device)
    _, rays = rdr.camera_rays(camera, smpl.make_sampler(smpl.SOBOL, SPP, RES), 0, SPP)
    n = rays.o.shape[0]
    t_max = torch.full((n,), torch.finfo(torch.float32).max, device=device)
    rnd = random_rays(SWEEP_RAYS, 6, device)
    mixed = random_table(MIXED_TRIS, 7, device, INF_ROWS + (NAN_ROW,))
    return {
        "camera": (rays.o.contiguous(), rays.d.contiguous(), t_max, scene.tri_attr, scene.n_tris),
        "random": (*rnd, random_table(SWEEP_TRIS, 6, device), SWEEP_TRIS),
        "mixed": (*rnd, mixed, MIXED_TRIS),
        "mixed without NaN": (*rnd, mixed, MIXED_TRIS - 1),
        "small mixed": (*rnd, random_table(SMALL_TRIS, 8, device, SMALL_INF_ROWS), SMALL_TRIS),
    }


def sweep_kernels():
    """(kind, id, kernel wrapper, plain version) of K3, K4, K5."""
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik

    return (("closest", "K3", ik.closest_sweep, ik.closest_sweep_plain),
            ("any", "K4", ik.any_sweep, ik.any_sweep_plain),
            ("full", "K5", ik.full_sweep, ik.full_sweep_plain))


def compare(kind: str, got, want) -> tuple:
    """(why a sweep launch differs from its plain version or "", the
    largest absolute difference of its rows): K4 equal; K3 tri ids equal,
    t, b0, b1 within TOL; K5 prim, mat, light equal, its 18 rows within
    TOL."""
    torch.cuda.synchronize()
    if kind == "any":
        bad = int((got != want).sum())
        return (f"{bad} occlusion bits differ" if bad else ""), 0.0
    if kind == "closest":
        ids_g, ids_w = got.tri, want.tri
        rows_g = torch.stack([got.t, got.b0, got.b1])
        rows_w = torch.stack([want.t, want.b0, want.b1])
    else:
        ids_g, ids_w, rows_g, rows_w = got.ids, want.ids, got.rows, want.rows
    err = float((rows_g - rows_w).abs().max()) if rows_g.numel() else 0.0
    if not torch.equal(ids_g, ids_w):
        return f"{int((ids_g != ids_w).sum())} ids differ", err
    if not torch.isfinite(rows_g).all() or not torch.allclose(rows_g, rows_w, rtol=TOL, atol=TOL):
        return f"rows differ by up to {err}", err
    return "", err


def replay(what: str, kind: str, fn, plain, args) -> float:
    """Holds fn(*args) to plain(*args), then its device time a call."""
    from rs_pbrt_tpu_torch.tools import k1_b2_replay

    why, _ = compare(kind, fn(*args), plain(*args))
    if why:
        raise AssertionError(f"{what}: {why} from the plain version")
    return k1_b2_replay.queued_ms(lambda: fn(*args), REPS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose rs_pbrt_tpu_torch is timed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.scene import presets
    from rs_pbrt_tpu_torch.tools import k1_b2_replay

    variant = args.root.resolve().name
    card = k1_b2_replay.card_name()
    kernels = {kind: (kid, fn, plain) for kind, kid, fn, plain in sweep_kernels()}
    total = {"any": 0.0, "full": 0.0}
    for integrator in ("directlighting", "whitted"):
        scene, camera = presets.spheres_direct(RES, device="cuda")
        cfg = rdr.RenderCfg(integrator, spp=SPP, max_depth=DEPTH, rr_threshold=1.0)
        scfg = smpl.make_sampler(smpl.SOBOL, SPP, RES)

        def go():
            return rdr.render(scene, camera, cfg, scfg, max_lanes=RES[0] * RES[1] * SPP)

        go()  # warm: builds the kernels, fills the caches
        for kind, name in (("any", "any_sweep"), ("full", "full_sweep")):
            kid, fn, plain = kernels[kind]
            ms = [replay(f"{integrator} {kid} launch {b}", kind, fn, plain, a)
                  for b, (a, _) in enumerate(k1_b2_replay.record(go, ik, name))]
            total[kind] += sum(ms)
            print(f"[sweep_replay] {integrator} ({variant}): {kid} {len(ms)} launches "
                  f"{', '.join(f'{t:.4f}' for t in ms)} ms = {sum(ms):.4f} ms on the card, "
                  f"each matching the plain version ({card})", flush=True)
    for name, a in sweep_inputs().items():
        ms = {kind: replay(f"{kid} {name}", kind, fn, plain, a)
              for kind, (kid, fn, plain) in kernels.items()}
        print(f"[sweep_replay] {name} ({variant}), {a[0].shape[0]} rays x {a[4]} triangles: "
              + ", ".join(f"{kernels[k][0]} {t:.4f} ms" for k, t in ms.items())
              + f" on the card, each matching the plain version ({card})", flush=True)
    print(f"[sweep_replay] ({variant}) the slice 2 renders' launches: K4 {total['any']:.4f} ms, "
          f"K5 {total['full']:.4f} ms on the card ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
