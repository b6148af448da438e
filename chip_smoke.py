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
   events.

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
TOL = 2e-3  # K2 and the render against their plain versions (rtol = atol)

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

    n = 1 << 22
    rng = np.random.default_rng(1)
    worst = 0.0
    for bits in (32, 52):
        index = torch.as_tensor(rng.integers(0, 1 << bits, n, dtype=np.int64), device="cuda")
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
    scfg = smpl.make_sampler(smpl.SOBOL, 4, camera.resolution)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, 4)
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


def profile_render(go, top: int = 12):
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
    print(f"[5 profile] device busy {busy:.3f} ms of a {wall_ms:.3f} ms profiled render "
          f"({100 * busy / wall_ms:.1f}%); {len(rows)} device ops, the top {top}:", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        print(f"[5 profile]   {ms:9.3f} ms {count:6d}x  {key[:90]}")


def phase_render(card):
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.scene import presets

    res, spp, depth = (256, 256), 64, 5
    scene, camera = presets.cornell_box(res)
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
        sk.launches = pk.launches = 0
        img = go()
        torch.cuda.synchronize()
        counts = {"sobol": sk.launches, "bounce": pk.launches}
    if counts != {"sobol": 1, "bounce": depth + 1}:
        fail(f"launch counts of the flagship render {counts}, expected sobol 1, "
             f"bounce {depth + 1}")
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
    profile_render(go)
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
        k1=dict(ms=k1_ms, plain_ms=p1t.times_ms()[0], bound_ms=k1_bound, max_abs_err=k1_err),
        k2=dict(ms=sum(k2_ms) / len(k2_ms), plain_ms=sum(p2_ms) / len(p2_ms),
                bound_ms=sum(k2_bounds) / len(k2_bounds), bound_by=k2_by, max_abs_err=k2_err),
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

    scene, camera = presets.cornell_box((256, 256))
    k2_err = phase_k2(scene, camera)
    r = phase_render(card)
    r["k1"]["max_abs_err"] = max(k1_err, r["k1"]["max_abs_err"])
    r["k2"]["max_abs_err"] = max(k2_err, r["k2"]["max_abs_err"])

    kernels = [
        dict(name="sobol_dims", route="cuda", source="rs_pbrt_tpu_torch/csrc/sobol.cu",
             replaces="rs_pbrt_tpu/ops/pallas_sobol.py:35", launches=r["counts"]["sobol"],
             bound_by="bytes", library_ms=None, **r["k1"]),
        dict(name="bounce", route="cuda", source="rs_pbrt_tpu_torch/csrc/bounce.cu",
             replaces="rs_pbrt_tpu/ops/pallas_path.py:410", launches=r["counts"]["bounce"],
             library_ms=None, **r["k2"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
