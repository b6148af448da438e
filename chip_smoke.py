#!/usr/bin/env python3
"""Drives rs_pbrt_tpu_torch's main path on one NVIDIA card and checks it.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, one line each (or more):

1. device: the card's name and power limit (nvidia-smi).
2. build: every CUDA source of rs_pbrt_tpu_torch/csrc, compiled by nvcc.
3. K1 (Sobol' dims) against its plain PyTorch version on 2^22 lanes, for
   32- and 52-bit indices: the outputs must be bit-equal.
4. K2 (one path-tracer bounce) against its plain version, one bounce and
   the emit-only launch, on the Cornell camera rays at 256x256x4 spp:
   all 13 lane rows (o, d, beta, L, prev_pdf) within rtol = atol = 2e-3,
   no lane alive in one and dead in the other.
5. the flagship render through the entry points a user calls: the Cornell
   box at 256x256, 64 spp in one batch, path integrator, depth 5.  The
   launch counters are zeroed just before it and read just after: K1 once,
   K2 max_depth + 1 times.  Each of that run's launches is held against
   its plain version on the same inputs (K1 bit-equal, K2 as in phase 4),
   and the plain bounce counts the lanes of each step for K2's bound.  The
   image must be finite and match the same render with every kernel
   wrapper swapped for its plain version, at rtol = atol = 2e-3.  Then
   camera paths/s (best of 3 warm renders), the device time by op over one
   render (torch.profiler) and each kernel's time per launch from CUDA
   events.  K3-K5 must not launch in it.
6. K3, K4, K5 (the triangle sweeps) against their plain versions on two
   inputs: the spheres_direct camera rays at 256x256x64 spp (4,194,304
   rays, t_max = FLT_MAX) on its 4 triangles, and 262,144 random rays
   (finite and infinite t_max, a few of zero direction) against 2048
   random triangles.  K4 exactly equal; K3 tri ids equal, t, b0, b1 within
   rtol = atol = 2e-3; K5 all 18 rows within 2e-3, prim, mat and light
   equal.  Kernel and plain times and bounds at both inputs.
7. The slice's renders through the entry points: spheres_direct at
   256x256, 64 spp in one batch, depth 5, with directlighting (strategy
   "all") and then whitted.  The counters are zeroed just before each and
   read just after: K1 1 + depth (camera dims, then each depth's block),
   K5 depth, K4 depth x n_lights, K2 and K3 none.  Every K1, K4 and K5
   launch of that run is held against its plain version on the same
   inputs (K1 bit-equal, K4 equal, K5 as in phase 6); the image must be
   finite and within rtol = atol = 2e-3 of the same render with every
   wrapper swapped for its plain version.  Then paths/s (best of 3 warm
   renders), the device time by op and each kernel's time per launch
   beside its bound.

Then one JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
TOL = 2e-3  # K2-K5 and the renders against their plain versions (rtol = atol)
DEVICE = "cuda"
# the main paths' size: 256x256 at 64 spp in one batch, depth 5
RES, SPP, DEPTH = (256, 256), 64, 5
K1_LANES = 1 << 22  # phase 3
K2_SPP = 4  # phase 4
SWEEP_RAYS, SWEEP_TRIS = 1 << 18, 2048  # phase 6's random input

# published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# K2's f32 arithmetic by step, counted in csrc/bounce.cu and
# csrc/watertight.cuh: add, sub, mul, div, sqrt, sin and cos one each;
# compares, min/max, abs, negation and selects are not counted.  The
# watertight terms leave out the products with the 0/1 entries of the
# one-hot permute matrix; the coordinate_system fallbacks of degenerate
# geometry are not charged.  Each step is charged to the lanes that run it,
# as bounce_plain counts them on the same inputs (its `work` dict).
K2_FLOP = dict(
    ray=7,  # ray_constants: 1/dz, sx, sy, cx, cy (per lane that sweeps)
    tri_closest=65,  # watertight_tri: shear 21, edges 9, det 2, scaled t 8,
    #                  t_lim*det 1, error bound 19; 1/det, b0, b1, t, delta_t 5
    tri_any=60,  # watertight_tri_any: the same without the last 5
    hit=53,  # record: b2, p, the edges, ng, the light id; wo
    hit_normals=30,  # record: ns from the vertex normals and its flip test
    emit_first=14,  # first bounce: the emitting-side test, L += beta*Le*w
    emit_mis=37,  # later bounces: + distance, cosine, area pdf, power heuristic
    shade_record=35,  # record: p_err, dpdu, the material id
    shade=128,  # frame, 7 Sobol' words to float, light pick, area sample,
    #            light pdf, f and the bsdf pdf toward the light
    light_normals=20,  # the light triangle's shading normal and its flip test
    sample=30,  # cosine sample: concentric disk (with sin, cos), z, pdf
    shadow=37,  # shadow origin, direction, length, its ray constants
    nee=19,  # power heuristic, 1/pdf, L += beta*kd*Li*w
    cont=44,  # world direction, |cos|, beta, the new origin
    rr=1,  # Russian roulette's q, per continuing lane
    rr_keep=5,  # the surviving lanes' beta / (1 - q)
)
LANE_BYTES = 13 * 4 * 2 + 4 * 2  # the 13 f32 rows and alive, in and out
# K3-K5's f32 arithmetic, counted as K2_FLOP is in csrc/intersect.cu,
# csrc/watertight.cuh and csrc/record.cuh
ISECT_FLOP = dict(
    ray=7,  # ray_constants, per ray
    tri_closest=65,  # watertight_tri, per triangle per ray
    tri_any=60,  # watertight_tri_any, per test up to the first occluder
    record=119,  # record.cuh per hit: b2 2, p 15, p_err 18, edges 6, ng 19, ns
    #              interpolated and its length 22, uv 10, dpdu 25, mat and light 2
    record_normals=8,  # where the triangle has vertex normals: ns scaled, flip test
)
RAY_BYTES = 7 * 4  # o, d, t_max in, per ray
VERT_BYTES = 9 * 4  # the vertex coordinates K3 and K4 read of a table row


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn() on the card, from CUDA events, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class LaunchTimer:
    """Wraps a kernel wrapper (or its plain version) to record CUDA events
    around every call, keeping the call's arguments (and with keep, its
    outputs) for the checks and the bound."""

    def __init__(self, fn, keep: bool = False):
        import torch

        self.fn, self.torch, self.keep, self.calls = fn, torch, keep, []

    def __call__(self, *args, **kw):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.fn(*args, **kw)
        ev[1].record()
        self.calls.append((ev, args, kw, out if self.keep else None))
        return out

    def times_ms(self):
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for (s, e), _, _, _ in self.calls]


def k2_bound_ms(work, args, kw):
    """Least time of one bounce launch on these inputs, as (bytes_ms,
    operations_ms); the bound is the larger.  work: the lane counts of each
    step, from bounce_plain on the same inputs.  Bytes: every lane's rows in
    and out, the index of the lanes that draw Sobol' samples, the tables the
    launch reads.  Operations: K2_FLOP per step times its lanes."""
    lanes, _alive, _index, tables, cfg = args
    f, w = K2_FLOP, work
    flop = w["live"] * (f["ray"] + cfg.n_tri * f["tri_closest"])
    flop += w["hit"] * (f["hit"] + (f["emit_first"] if kw["first_bounce"] else f["emit_mis"]))
    flop += w["hit_normals"] * f["hit_normals"]
    row = tables.tris.shape[1] * 4
    nbytes = (lanes.shape[1] * LANE_BYTES + cfg.n_tri * row + tables.lattr.numel() * 4
              + tables.lsel.numel() * 4)
    if not kw["emit_only"]:
        flop += w["hit"] * (f["shade_record"] + f["shade"] + f["sample"])
        flop += w["light_normals"] * f["light_normals"]
        flop += w["shadow"] * f["shadow"] + w["shadow_tests"] * f["tri_any"]
        flop += w["unoccluded"] * f["nee"] + w["cont"] * f["cont"]
        if kw["rr_active"]:
            flop += w["cont"] * f["rr"] + w["rr_keep"] * f["rr_keep"]
        sobol_rows = 7 * 52 * 4  # the bounce's 7 dims of 52 direction numbers
        nbytes += (w["hit"] * 8 + (tables.ltricdf.numel() + tables.mattr.numel()) * 4
                   + sobol_rows)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def _kernel_modules():
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk

    return sk, pk, ik


def zero_counts():
    """Every kernel's launch count to 0."""
    sk, pk, ik = _kernel_modules()
    sk.launches = pk.launches = 0
    ik.launches.update(dict.fromkeys(ik.launches, 0))


def read_counts() -> dict:
    sk, pk, ik = _kernel_modules()
    return dict(sobol=sk.launches, bounce=pk.launches, **ik.launches)


def _owner(name: str):
    """The module of the kernel wrapper `name` (sobol_dims, bounce,
    closest_sweep, any_sweep, full_sweep)."""
    sk, pk, ik = _kernel_modules()
    return dict(sobol_dims=sk, bounce=pk, closest_sweep=ik, any_sweep=ik, full_sweep=ik)[name]


def wrapper(name: str):
    return getattr(_owner(name), name)


def patched(stack: ExitStack, **fns):
    """Swaps the wrappers named in fns for the given callables until stack
    closes."""
    for name, fn in fns.items():
        stack.enter_context(mock.patch.object(_owner(name), name, fn))


def isect_bound_ms(kind: str, args, out) -> tuple:
    """Least time of one K3 (closest), K4 (any) or K5 (full) launch on these
    inputs, as (bytes_ms, operations_ms).  Bytes: each ray's o, d and t_max
    in and its outputs out (K3 16, K4 1, K5 84 bytes), and the table once
    (the vertex coordinates for K3 and K4, whole rows for K5).  Operations:
    ISECT_FLOP, K4's tests counted up to each ray's first occluder and K5's
    record charged to the rays that hit."""
    import torch

    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops.watertight import any_sweep_tests
    from rs_pbrt_tpu_torch.scene import arrays as sa

    o, d, t_max, tris, n_tri = args
    n, f = o.shape[0], ISECT_FLOP
    if kind == "any":
        o3, d3 = tuple(o.unbind(-1)), tuple(d.unbind(-1))
        tests = any_sweep_tests(tris, n_tri, o3, d3, t_max,
                                torch.ones(n, dtype=torch.bool, device=o.device))
        nbytes, flop = n * (RAY_BYTES + 1) + n_tri * VERT_BYTES, n * f["ray"] + tests * f["tri_any"]
    else:
        flop = n * (f["ray"] + n_tri * f["tri_closest"])
        if kind == "closest":
            nbytes = n * (RAY_BYTES + 16) + n_tri * VERT_BYTES
        else:
            valid = out.valid
            prim = out.ids[ik.I_PRIM].clamp(min=0).long()
            normals = valid & (tris[prim, sa.TA_HAS_N] > 0.5)
            flop += int(valid.sum()) * f["record"] + int(normals.sum()) * f["record_normals"]
            nbytes = n * (RAY_BYTES + 4 * (ik.N_F_ROWS + 3)) + n_tri * tris.shape[1] * 4
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def check_isect(what: str, kind: str, got, want) -> float:
    """Fails unless a sweep launch matches its plain version: K4 equal; K3
    tri ids equal, t, b0, b1 within TOL; K5 prim, mat, light equal, its 18
    rows within TOL.  Returns the largest absolute difference."""
    import torch

    torch.cuda.synchronize()
    if kind == "any":
        if not torch.equal(got, want):
            fail(f"{what}: {int((got != want).sum())} occlusion bits differ from the plain version")
        return 0.0
    if kind == "closest":
        ids_g, ids_w = got.tri, want.tri
        rows_g, rows_w = torch.stack([got.t, got.b0, got.b1]), torch.stack([want.t, want.b0, want.b1])
    else:
        ids_g, ids_w, rows_g, rows_w = got.ids, want.ids, got.rows, want.rows
    if not torch.equal(ids_g, ids_w):
        fail(f"{what}: {int((ids_g != ids_w).sum())} ids differ from the plain version")
    err = float((rows_g - rows_w).abs().max()) if rows_g.numel() else 0.0
    if not torch.isfinite(rows_g).all() or not torch.allclose(rows_g, rows_w, rtol=TOL, atol=TOL):
        fail(f"{what}: rows differ from the plain version by up to {err}")
    return err


def k1_bound_ms(n: int, n_dims: int) -> float:
    """8 bytes of index in and 4 per dim out per lane, over the memory rate."""
    return 1e3 * n * (8 + 4 * n_dims) / HBM_BYTES_PER_S


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}", flush=True)
    return card


def phase_build():
    from rs_pbrt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    out = _build.build_all(verbose=True)
    print(f"[2 build] {sorted(p.name for p in out.glob('*.so'))} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)


def phase_k1(card):
    import numpy as np
    import torch

    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk

    n = K1_LANES
    rng = np.random.default_rng(1)
    worst = 0.0
    for bits in (32, 52):
        index = torch.as_tensor(rng.integers(0, 1 << bits, n, dtype=np.int64), device=DEVICE)
        got = sk.sobol_dims(index, 0, 5, bits)
        want = sk.sobol_dims_plain(index, 0, 5, bits)
        torch.cuda.synchronize()
        worst = max(worst, float((got - want).abs().max()))
        if not torch.equal(got, want):
            fail(f"K1 {bits}-bit: {int((got != want).sum())} of {got.numel()} values differ "
                 "from the plain version")
        ms = cuda_ms(lambda: sk.sobol_dims(index, 0, 5, bits), 20)
        plain_ms = cuda_ms(lambda: sk.sobol_dims_plain(index, 0, 5, bits), 3)
        print(f"[3 K1] {bits}-bit index, {n} lanes x 5 dims: bit-equal to the plain version; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {k1_bound_ms(n, 5):.4f} ms "
              f"({card})", flush=True)
    return worst


def phase_k2(scene, camera):
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import path_kernel as pk

    cfg = pk.mega_cfg(scene)
    tables = pk.mega_tables(scene)
    scfg = smpl.make_sampler(smpl.SOBOL, K2_SPP, camera.resolution)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, K2_SPP)
    index, bits = ctx.global_index, smpl.index_bits(scfg)
    lanes, alive = pk.init_lanes(rays.o, rays.d)
    kw = dict(dim_row=pathmod.DIM_CAMERA, n_bits=bits, first_bounce=True, rr_active=False,
              emit_only=False, rr_threshold=1.0)
    ekw = dict(kw, dim_row=0, first_bounce=False, emit_only=True)
    worst = 0.0
    for step, args in (("bounce", kw), ("emit-only", ekw)):
        got = pk.bounce(lanes, alive, index, tables, cfg, **args)
        want = pk.bounce_plain(lanes, alive, index, tables, cfg, **args)
        err = check_k2_launch(f"K2 {step}", got, want)
        worst = max(worst, err)
        print(f"[4 K2] {step}, {lanes.shape[1]} lanes: o, d, beta, L, prev_pdf within {TOL} "
              f"(max abs err {err:.3g}), alive equal", flush=True)
        lanes, alive = got
    return worst


def check_k2_launch(what, got, want) -> float:
    """Fails unless the kernel's (lanes, alive) of one launch match the plain
    version's: alive equal, every lane row finite and within TOL.  Returns
    the largest absolute difference over the 13 rows."""
    import torch

    torch.cuda.synchronize()
    bad_alive = int((got[1] != want[1]).sum())
    if bad_alive:
        fail(f"{what}: {bad_alive} lanes alive in one version and dead in the other")
    if not torch.isfinite(got[0]).all():
        fail(f"{what}: non-finite lane values")
    err = float((got[0] - want[0]).abs().max())
    if not torch.allclose(got[0], want[0], rtol=TOL, atol=TOL):
        fail(f"{what}: lane rows differ from the plain version by up to {err}")
    return err


def profile_render(go, tag: str, top: int = 12):
    """Device time by op over one warm render (torch.profiler), and the
    device's busy share of that render's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only (kernels, copies): a CPU op's entry repeats
    # the device time of the kernels it launched
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    print(f"[{tag}] device busy {busy:.3f} ms of a {wall_ms:.3f} ms profiled render "
          f"({100 * busy / wall_ms:.1f}%); {len(rows)} device ops, the top {top}:", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        print(f"[{tag}]   {ms:9.3f} ms {count:6d}x  {key[:90]}")


def phase_render(card):
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.scene import presets

    res, spp, depth = RES, SPP, DEPTH
    scene, camera = presets.cornell_box(res, device=DEVICE)
    cfg = rdr.RenderCfg("path", spp=spp, max_depth=depth, rr_threshold=1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, spp, res)
    lanes = res[0] * res[1] * spp

    def go(stats=None):
        return rdr.render(scene, camera, cfg, scfg, max_lanes=lanes, stats=stats)

    # the main path's run: the wrappers are recorded (arguments and outputs)
    # on their way to the kernels, which count their own launches
    k1r, k2r = LaunchTimer(sk.sobol_dims, keep=True), LaunchTimer(pk.bounce, keep=True)
    with ExitStack() as es:
        es.enter_context(mock.patch.object(sk, "sobol_dims", k1r))
        es.enter_context(mock.patch.object(pk, "bounce", k2r))
        zero_counts()
        img = go()
        torch.cuda.synchronize()
        counts = read_counts()
    want = dict(sobol=1, bounce=depth + 1, closest_sweep=0, any_sweep=0, full_sweep=0)
    if counts != want:
        fail(f"launch counts of the flagship render {counts}, expected {want}")
    if tuple(img.shape) != (res[1], res[0], 3) or not torch.isfinite(img).all():
        fail(f"flagship image: shape {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")

    # each launch of that run against its plain version on the same inputs;
    # the plain bounce also counts the lanes of each step for the bound
    (_, k1_args, k1_kw, k1_out), = k1r.calls
    k1_want = sk.sobol_dims_plain(*k1_args, **k1_kw)
    torch.cuda.synchronize()
    k1_err = float((k1_out - k1_want).abs().max())
    if not torch.equal(k1_out, k1_want):
        fail(f"flagship K1 launch differs from its plain version by up to {k1_err}")
    k1_bound = k1_bound_ms(k1_args[0].shape[0], k1_args[2])
    k2_err, k2_parts, k2_work = 0.0, [], []
    for b, (_, args, kw, out) in enumerate(k2r.calls):
        work = {}
        want = pk.bounce_plain(*args, **kw, work=work)
        k2_err = max(k2_err, check_k2_launch(f"flagship K2 launch {b}", out, want))
        k2_parts.append(k2_bound_ms(work, args, kw))
        k2_work.append(work)
    del k1r, k2r, k1_args, k1_out, k1_want, args, out, want
    print(f"[5 render] each flagship launch matches its plain version: K1 bit-equal, K2 "
          f"within {TOL} on all 13 lane rows (max abs err {k2_err:.3g}), alive equal", flush=True)
    for b, (work, (bms, fms)) in enumerate(zip(k2_work, k2_parts)):
        print(f"[5 bound] K2 launch {b}: lanes by step {work}; bytes {bms:.4f} ms, "
              f"operations {fms:.4f} ms", flush=True)

    best = None
    for _ in range(3):
        st = {}
        go(st)
        best = st if best is None or st["wall_s"] < best["wall_s"] else best

    # each kernel's time per launch, from events around every wrapper call;
    # per launch the best of 3 renders
    k1_runs, k2_runs = [], []
    for _ in range(3):
        k1t, k2t = LaunchTimer(sk.sobol_dims), LaunchTimer(pk.bounce)
        with ExitStack() as es:
            es.enter_context(mock.patch.object(sk, "sobol_dims", k1t))
            es.enter_context(mock.patch.object(pk, "bounce", k2t))
            go()
        k1_runs.append(k1t.times_ms())
        k2_runs.append(k2t.times_ms())
    k1_ms = min(r[0] for r in k1_runs)
    k2_ms = [min(col) for col in zip(*k2_runs)]
    profile_render(go, "5 profile")
    # the same render with every wrapper swapped for its plain version
    p1t, p2t = LaunchTimer(sk.sobol_dims_plain), LaunchTimer(pk.bounce_plain)
    with ExitStack() as es:
        es.enter_context(mock.patch.object(sk, "sobol_dims", p1t))
        es.enter_context(mock.patch.object(pk, "bounce", p2t))
        img_plain = go()
    torch.cuda.synchronize()
    err = float((img - img_plain).abs().max())
    if not torch.allclose(img, img_plain, rtol=TOL, atol=TOL):
        fail(f"flagship image differs from the plain render by up to {err}")

    p2_ms = p2t.times_ms()
    k2_bounds = [max(p) for p in k2_parts]
    k2_by = ("operations" if sum(p[1] for p in k2_parts) >= sum(p[0] for p in k2_parts)
             else "bytes")
    print(f"[5 render] Cornell {res[0]}x{res[1]}, {spp} spp, depth {depth}, one batch of "
          f"{lanes} lanes: finite, matches the plain render (max abs err {err:.3g}, mean "
          f"{float(img.mean()):.5f}); launches {counts}", flush=True)
    print(f"[5 render] {best['paths_per_s']:.6g} camera paths/s (best of 3 warm renders, "
          f"{1e3 * best['wall_s']:.3f} ms) on {card}", flush=True)
    print(f"[5 render] K1 per launch {k1_ms:.4f} ms; K2 per launch "
          f"{', '.join(f'{t:.3f}' for t in k2_ms)} ms (bounds "
          f"{', '.join(f'{b:.4f}' for b in k2_bounds)} ms); plain render K1 "
          f"{p1t.times_ms()[0]:.3f} ms, K2 {', '.join(f'{t:.1f}' for t in p2_ms)} ms", flush=True)
    return dict(
        counts=counts, err=err,
        k1=dict(ms=[k1_ms], plain_ms=p1t.times_ms(), bound=[(k1_bound, 0.0)], max_abs_err=k1_err),
        k2=dict(ms=sum(k2_ms) / len(k2_ms), plain_ms=sum(p2_ms) / len(p2_ms),
                bound_ms=sum(k2_bounds) / len(k2_bounds), bound_by=k2_by, max_abs_err=k2_err),
    )


def random_sweep_inputs(n_rays: int, n_tri: int, seed: int):
    """(o, d, t_max, table, n_tri) on the card: rays from the box
    [-2.5, 2.5]^3 in random directions, a fifth ending at t = 2.5 and the
    rest at FLT_MAX, the first 16 of zero direction; a tri_attr table of
    random triangles in [-2, 2]^3, a third with vertex normals, random uv,
    materials and lights, a fifth reversed (tests/test_pallas.py:28-37)."""
    import numpy as np
    import torch

    from rs_pbrt_tpu_torch.scene import arrays as sa

    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16] = 0.0
    t_max = np.where(rng.uniform(size=n_rays) < 0.2, 2.5, np.finfo(np.float32).max)
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
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=DEVICE)
    return f32(o), f32(d), f32(t_max), f32(tab), n_tri


def phase_sweeps(card):
    """Phase 6: K3, K4, K5 against their plain versions, timed, with their
    bounds, on the slice's camera rays and on a large random table.
    Returns, per kind, the camera rays' numbers and the worst error."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.scene import presets

    res, spp = RES, SPP
    scene, camera = presets.spheres_direct(res, device=DEVICE)
    _, rays = rdr.camera_rays(camera, smpl.make_sampler(smpl.SOBOL, spp, res), 0, spp)
    n = rays.o.shape[0]
    t_max = torch.full((n,), torch.finfo(torch.float32).max, device=DEVICE)
    inputs = {
        "camera": (rays.o.contiguous(), rays.d.contiguous(), t_max, scene.tri_attr, scene.n_tris),
        "random": random_sweep_inputs(SWEEP_RAYS, SWEEP_TRIS, 6),
    }
    out = {}
    for name, args in inputs.items():
        for kind, kid, fn, plain in (("closest", "K3", ik.closest_sweep, ik.closest_sweep_plain),
                                     ("any", "K4", ik.any_sweep, ik.any_sweep_plain),
                                     ("full", "K5", ik.full_sweep, ik.full_sweep_plain)):
            got = fn(*args)
            err = check_isect(f"{kid} {name}", kind, got, plain(*args))
            ms = cuda_ms(lambda: fn(*args), 20)
            plain_ms = cuda_ms(lambda: plain(*args), 2)
            bms, fms = isect_bound_ms(kind, args, got)
            hits = float((got if kind == "any" else got.valid).float().mean())
            print(f"[6 {kid}] {name}: {args[0].shape[0]} rays x {args[4]} triangles, "
                  f"{100 * hits:.1f}% hit; matches the plain version (max abs err {err:.3g}); "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {max(bms, fms):.4f} ms "
                  f"(bytes {bms:.4f}, operations {fms:.4f}) ({card})", flush=True)
            if name == "camera":  # the main paths' shape
                out[kind] = dict(ms=[ms], plain_ms=[plain_ms], bound=[(bms, fms)], max_abs_err=err)
            out[kind]["max_abs_err"] = max(out[kind]["max_abs_err"], err)
    return out


def phase_slice_render(card, integrator: str):
    """Phase 7: spheres_direct through render.render with `integrator`."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.scene import presets

    res, spp, depth = RES, SPP, DEPTH
    tag = f"7 {integrator}"
    scene, camera = presets.spheres_direct(res, device=DEVICE)
    cfg = rdr.RenderCfg(integrator, spp=spp, max_depth=depth, rr_threshold=1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, spp, res)
    lanes = res[0] * res[1] * spp

    def go(stats=None):
        return rdr.render(scene, camera, cfg, scfg, max_lanes=lanes, stats=stats)

    # the main path's run, its wrapper calls recorded with their outputs
    names = ("sobol_dims", "any_sweep", "full_sweep")
    rec = {k: LaunchTimer(wrapper(k), keep=True) for k in names}
    with ExitStack() as es:
        patched(es, **rec)
        zero_counts()
        img = go()
        torch.cuda.synchronize()
        counts = read_counts()
    want = dict(sobol=1 + depth, bounce=0, closest_sweep=0, any_sweep=depth * scene.n_lights,
                full_sweep=depth)
    if counts != want:
        fail(f"launch counts of the {integrator} render {counts}, expected {want}")
    if tuple(img.shape) != (res[1], res[0], 3) or not torch.isfinite(img).all():
        fail(f"{integrator} image: shape {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")

    # each launch of that run against its plain version on the same inputs
    errs = dict(sobol_dims=0.0, any_sweep=0.0, full_sweep=0.0)
    bounds = {k: [] for k in names}
    for b, (_, args, kw, out) in enumerate(rec["sobol_dims"].calls):
        want_k1 = sk.sobol_dims_plain(*args, **kw)
        torch.cuda.synchronize()
        errs["sobol_dims"] = max(errs["sobol_dims"], float((out - want_k1).abs().max()))
        if not torch.equal(out, want_k1):
            fail(f"{integrator} K1 launch {b} differs from its plain version")
        bounds["sobol_dims"].append((k1_bound_ms(args[0].shape[0], args[2]), 0.0))
    for key, kind, kid, plain in (("any_sweep", "any", "K4", ik.any_sweep_plain),
                                  ("full_sweep", "full", "K5", ik.full_sweep_plain)):
        for b, (_, args, kw, out) in enumerate(rec[key].calls):
            errs[key] = max(errs[key], check_isect(f"{integrator} {kid} launch {b}", kind, out,
                                                   plain(*args, **kw)))
            bounds[key].append(isect_bound_ms(kind, args, out))
    del rec, args, kw, out
    print(f"[{tag}] each launch matches its plain version: K1 bit-equal, K4 equal, K5 within "
          f"{TOL} (max abs err {errs['full_sweep']:.3g}), ids equal", flush=True)

    best = None
    for _ in range(3):
        st = {}
        go(st)
        best = st if best is None or st["wall_s"] < best["wall_s"] else best
    # each kernel's time per launch: events around every wrapper call, per
    # launch the best of 3 renders
    runs = []
    for _ in range(3):
        timers = {k: LaunchTimer(wrapper(k)) for k in names}
        with ExitStack() as es:
            patched(es, **timers)
            go()
        runs.append({k: t.times_ms() for k, t in timers.items()})
    ms = {k: [min(col) for col in zip(*(r[k] for r in runs))] for k in names}
    profile_render(go, f"7 profile {integrator}")
    # the same render with every wrapper swapped for its plain version
    plain_t = dict(sobol_dims=LaunchTimer(sk.sobol_dims_plain),
                   any_sweep=LaunchTimer(ik.any_sweep_plain),
                   full_sweep=LaunchTimer(ik.full_sweep_plain))
    with ExitStack() as es:
        patched(es, closest_sweep=ik.closest_sweep_plain, bounce=pk.bounce_plain, **plain_t)
        img_plain = go()
    torch.cuda.synchronize()
    err = float((img - img_plain).abs().max())
    if not torch.allclose(img, img_plain, rtol=TOL, atol=TOL):
        fail(f"{integrator} image differs from the plain render by up to {err}")
    plain_ms = {k: t.times_ms() for k, t in plain_t.items()}

    print(f"[{tag}] spheres_direct {res[0]}x{res[1]}, {spp} spp, depth {depth}, one batch of "
          f"{lanes} lanes: finite, matches the plain render (max abs err {err:.3g}, mean "
          f"{float(img.mean()):.5f}); launches {counts}", flush=True)
    print(f"[{tag}] {best['paths_per_s']:.6g} camera paths/s (best of 3 warm renders, "
          f"{1e3 * best['wall_s']:.3f} ms) on {card}", flush=True)
    for k, kid in (("sobol_dims", "K1"), ("full_sweep", "K5"), ("any_sweep", "K4")):
        print(f"[{tag}] {kid} per launch {', '.join(f'{t:.4f}' for t in ms[k])} ms; bounds "
              f"{', '.join(f'{max(b):.4f}' for b in bounds[k])} ms; plain "
              f"{', '.join(f'{t:.3f}' for t in plain_ms[k])} ms", flush=True)
    out = {k: dict(ms=ms[k], plain_ms=plain_ms[k], bound=bounds[k], max_abs_err=errs[k])
           for k in names}
    return dict(out, counts=counts)


def kernel_entry(name, source, replaces, launches, parts, max_abs_err) -> dict:
    """One kernel's line of the `kernels` JSON: per-launch means over
    `parts`, dicts of per-launch lists ms, plain_ms and bound ((bytes_ms,
    operations_ms) pairs)."""
    mean = lambda xs: sum(xs) / len(xs)
    ms = [t for p in parts for t in p["ms"]]
    plain_ms = [t for p in parts for t in p["plain_ms"]]
    bounds = [b for p in parts for b in p["bound"]]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=max_abs_err, ms=mean(ms), plain_ms=mean(plain_ms),
        bound_ms=mean([max(b) for b in bounds]),
        bound_by="operations" if sum(b[1] for b in bounds) >= sum(b[0] for b in bounds) else "bytes",
        library_ms=None,
    )


def main():
    if not (ROOT / "rs_pbrt_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no rs_pbrt_tpu_torch/csrc)")
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    k1_err = phase_k1(card)
    from rs_pbrt_tpu_torch.scene import presets

    scene, camera = presets.cornell_box(RES, device=DEVICE)
    k2_err = phase_k2(scene, camera)
    flag = phase_render(card)
    flag["k1"]["max_abs_err"] = max(k1_err, flag["k1"]["max_abs_err"])
    flag["k2"]["max_abs_err"] = max(k2_err, flag["k2"]["max_abs_err"])
    sweeps = phase_sweeps(card)
    slices = [phase_slice_render(card, integrator) for integrator in ("directlighting", "whitted")]

    k2 = flag["k2"]
    csrc, pallas = "rs_pbrt_tpu_torch/csrc/", "rs_pbrt_tpu/ops/pallas_intersect.py:"
    worst = lambda key, *more: max([p["max_abs_err"] for p in more]
                                   + [r[key]["max_abs_err"] for r in slices])
    kernels = [
        kernel_entry("sobol_dims", csrc + "sobol.cu", "rs_pbrt_tpu/ops/pallas_sobol.py:35",
                     flag["counts"]["sobol"] + sum(r["counts"]["sobol"] for r in slices),
                     [flag["k1"]] + [r["sobol_dims"] for r in slices],
                     worst("sobol_dims", flag["k1"])),
        dict(name="bounce", route="cuda", source=csrc + "bounce.cu",
             replaces="rs_pbrt_tpu/ops/pallas_path.py:410", launches=flag["counts"]["bounce"],
             library_ms=None, **k2),
        # K3 is on no render path: its numbers are phase 6's at the camera rays
        kernel_entry("closest_sweep", csrc + "intersect.cu", pallas + "133", 0,
                     [sweeps["closest"]], sweeps["closest"]["max_abs_err"]),
        kernel_entry("any_sweep", csrc + "intersect.cu", pallas + "285",
                     sum(r["counts"]["any_sweep"] for r in slices),
                     [r["any_sweep"] for r in slices], worst("any_sweep", sweeps["any"])),
        kernel_entry("full_sweep", csrc + "intersect.cu", pallas + "376",
                     sum(r["counts"]["full_sweep"] for r in slices),
                     [r["full_sweep"] for r in slices], worst("full_sweep", sweeps["full"])),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
