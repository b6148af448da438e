#!/usr/bin/env python3
"""Drives rs_pbrt_tpu_torch's main path on one NVIDIA card and checks it.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, one line each (or more):

1. device: the card's name and power limit (nvidia-smi).
2. build: every CUDA source of rs_pbrt_tpu_torch/csrc, compiled by nvcc;
   each kernel's registers, shared memory and stack frame (-Xptxas -v).
3. K1 (Sobol' dims) against its plain PyTorch version on random indices:
   32- and 52-bit and the render paths' exact widths (22 and 19 bits), 1,
   5, 35 and 128 dims, and the table's last 128 dims; the outputs and their
   strides must be equal.  Its device time (queued behind a sleeping
   kernel) beside the bound.
4. K2 (one path-tracer bounce) against its plain version, one bounce and
   the emit-only launch, on the Cornell camera rays at 256x256x4 spp:
   all 13 lane rows (o, d, beta, L, prev_pdf) within rtol = atol = 2e-3,
   no lane alive in one and dead in the other; each with the sweeps'
   shear picked by index (what a table of finite vertices gets) and in the
   one-hot form.  K2 updates the lane state in place, so the kernel gets a
   copy of the inputs the plain version gets.  Then every launch of a
   256x256x4 spp render of tools/k2_replay.curtain_scene, 2,028 triangles
   (near K2's largest table, which stays in device memory), held against
   the plain version as above and timed on replays of its inputs.
5. the flagship render through the entry points a user calls: the Cornell
   box at 256x256, 64 spp in one batch, path integrator, depth 5.  The
   launch counters are zeroed just before it and read just after: K1 once,
   K2 max_depth + 1 times.  Each of that run's launches is held against
   its plain version on the same inputs (K1 bit-equal and its device time
   from the launch replayed queued, K2 as in phase 4;
   K2's inputs and outputs are copied as the run makes them, since each
   launch overwrites them), and the plain bounce counts the lanes of each
   step for K2's bound.  The
   image must be finite and match the same render with every kernel
   wrapper swapped for its plain version, at rtol = atol = 2e-3.  Then
   camera paths/s (best of 3 warm renders), the device time by op over one
   render (torch.profiler) and each kernel's time per launch from CUDA
   events; per K2 launch its live lanes, its bound and its share of it,
   beside the one-thread-per-lane kernel's times, recorded in an earlier run
   and printed as such.  K3-K5 must not launch in it.
6. K3, K4, K5 (the triangle sweeps) against their plain versions on the
   inputs of rs_pbrt_tpu_torch/tools/sweep_replay.sweep_inputs: the
   spheres_direct camera rays at 256x256x64 spp (4,194,304 rays, t_max =
   FLT_MAX) on its 4 triangles; 262,144 random rays (finite and infinite
   t_max, a few of zero direction) against 2048 random triangles; the same
   rays against a 300-row table (a 256-row chunk of K3 and K4 and a tail of
   44) with three rows that hold an infinite vertex and, last, one a NaN
   vertex, swept whole and without the NaN row (which occludes every
   ray); the same rays against 40 rows (one chunk, the render paths'
   kernels) with three rows that hold an infinite vertex.  K4 exactly
   equal; K3 tri ids equal, t, b0, b1 within rtol = atol = 2e-3; K5 all
   18 rows within 2e-3, prim, mat and light equal.  Kernel times on the
   card alone (device_ms: queued behind a sleeping kernel)
   and by events, plain times and bounds at each input, beside the
   one-thread-a-ray K3's and K4's device times, recorded constants.
7. The slice's renders through the entry points: spheres_direct at
   256x256, 64 spp in one batch, depth 5, with directlighting (strategy
   "all") and then whitted.  The counters are zeroed just before each and
   read just after: K1 1 + depth (camera dims, then each depth's block),
   K5 depth, K4 depth x n_lights, K2 and K3 none.  Every K1, K4 and K5
   launch of that run is held against its plain version on the same
   inputs (K1 bit-equal, K4 equal, K5 as in phase 6), and each K1, K4
   and K5 launch replayed queued for its device time (the one-thread-a-ray
   K4's, recorded, beside it); the image must be
   finite and within rtol = atol = 2e-3 of the same render with every
   wrapper swapped for its plain version.  Then paths/s (best of 3 warm
   renders), the device time by op and each kernel's time per launch
   beside its bound.

8. The probe (rs_pbrt_tpu_torch/tools/probe.py) through its entry point,
   the counters zeroed just before and read just after: P1 and P2 launch
   in it, no other kernel.  Then P1 (take_rows) and P2 (take_loop) against
   their plain versions, each launched once and bit-equal, on the inputs
   of rs_pbrt_tpu_torch/tools/probe_replay.probe_cases: (16, 2048) at 1000
   steps, the probe's shape; (16, 2000), P2's remainder path; (3, 16), a
   power of two below 32 in less than one block; (5, 2047), P1's scalar
   tail; 0, 1 and 7 steps at (16, 2048), the jump-ahead's tail; (528,
   2048), 4 rows an SM.  Their device times a launch at (16, 2048), from
   launches queued behind a sleeping kernel (P1 takes less time on the
   card than the host takes to make a call), beside their bounds, P1
   beside torch.gather on the same inputs and the card's floor for one
   launch (launch_floor_ms: torch.cuda._sleep(0) queued the same way), P2's
   row-fetches/s, and P2's time at (528, 2048) beside its bound.
9. The statue through the entry points: statue_scene(subdivisions=8),
   1,310,724 triangles, and its BVH (build_accel), their host seconds;
   then the path integrator at 256x256, 8 spp in one batch of 524,288
   paths, depth 5.  The counters are zeroed just before the render and
   read just after: B1 depth + 1, B2 depth, K1 2 (the camera dims and the
   bounce dims of all bounces), no other kernel; the traversal stack
   overflowed 0 times.  Every B1 and B2 launch of that run is held
   against bvh12_intersect_plain on the same inputs (valid, tri, t, b0,
   b1 equal), every K1 launch bit-equal; the image must be finite and
   within rtol = atol = 2e-3 of the render with B1, B2 and K1 swapped for
   their plain versions.  B1 and B2 also run on the hand-built tie and NaN
   tree of rs_pbrt_tpu_torch/tools/bvh_ties.py, bit-equal to the plain
   traversal, and B2 on the first shadow launch cut to 16,389 rays (the
   last group fetch holds 5 rays).  Then paths/s (best of 3 warm renders),
   the device time by op, and each kernel's time per launch beside its
   bound (counted from the rows each ray visits), with B1's rays/s and row
   visits/s.  B1's and
   B2's times are the events around each call, as for every kernel, and
   beside them (device_ms in the JSON line) their device times, each
   launch's recorded inputs replayed behind a sleeping kernel: in this
   host-bound render the events also time the host's share of a call.
   K1's device_ms is the same replay of its launches in phases 5, 7 and 9,
   K4's and K5's of theirs in phase 7, K3's of phase 6's camera rays.
   The one-thread-a-lane K1 and one-thread-a-ray B2's device times on the
   same launches are printed beside them as recorded constants.  This
   phase renders with regen=False: the fixed-depth loop whose launch counts
   it checks.
10. Path regeneration at a narrow lane width, which forces many refills:
   regen.radiance_regen on the statue's 524,288 camera paths of phase 9
   through a pool of REGEN_CHECK_WIDTH lanes.  The counters are zeroed
   just before it and read just after: K1 once (the hoisted table), B1
   and B2 once each an iteration, no other kernel; no stack overflow.  B1
   and B2 of the first iteration, of the middle one and of the last that
   casts a ray are held to bvh12_intersect_plain bit for bit; the
   per-path radiance to general_radiance's on the same rays at rtol 1e-5,
   atol 1e-6 (the JAX package's bound, tests/test_regen.py:57).
11. Spatial light selection and a crop window through render.render:
   spheres_direct (two lights, below the BVH threshold) with the path
   integrator and light_strategy "spatial" (the general bounce: K1 2, K5
   depth + 1, K4 depth launches), and the Cornell box with a crop window
   (K1 1, K2 depth + 1), each at 256x256, 64 spp, depth 5, each image held
   to the render with every wrapper swapped for its plain version at
   rtol = atol = 2e-3, the crop's pixels outside its window black.
12. The slice at full width through render's defaults: the 5,242,880-
   triangle statue (statue_scene(subdivisions=9)) and its BVH, their host
   seconds; a warm render of 1 spp, then one timed render of 1024x1024, 64
   spp, depth 5 with regeneration (bench.py:252-277).  The counters are
   zeroed just before that render and read just after: K1 2 a batch, B1
   and B2 once each a regeneration iteration; no stack overflow.  Its
   batches, lane width, iterations, paths/s and peak device memory; the
   image finite and within rtol 1e-5, atol 1e-6 of the same render with
   regen=False in the same batches (each path takes the same samples and
   arithmetic in both); the fixed-depth render's paths/s and peak device
   memory; the device time by op over one batch, and the bounds of that
   batch's middle B1 and B2 launches (2^21 rays), counted on one ray in 32
   and scaled.  Phase 11 also times the spatial distribution's build.
13. The curve kernels C1-C4 against their plain versions on the card
   (rs_pbrt_tpu_torch/tools/curve_cases.py): 262,144 random rays (finite,
   infinite and FLT_MAX t_max, 16 of zero direction) against the 8,192-
   fibre fur patch's tree (C1, C2; 262,144 segments, their host seconds)
   and against hair_patch's 48 segments (C3, C4); 262,144 rays aimed at a
   1,024-row table of flat, cylinder and ribbon segments with zero-width
   and collapsed rows (C3, C4); the same rays against a tree over 162 of
   those rows whose walk overflows the 64-entry stack (C1, C2; the
   kernel's clamp count equal to the plain walk's).  valid, seg and the
   any hits equal; t, u, v, w bit-equal, else within rtol = atol = 2e-3
   (the line says which).  Each kernel's time on the card (queued behind a
   sleeping kernel), by events, its plain time and its bound.
14. The hair renders through render.render at 200x200, 16 spp, path,
   depth 5: tools/hair_scenes.hair_patch() (the fixed-depth loop: K1 2,
   K5 6, K4 5, C3 6, C4 5, nothing else; every launch held to its plain
   version) and fur_patch() (8,192 fibres, regeneration through 2^18
   lanes: K1 2, K4 = K5 = C1 = C2 = the iterations; C1 and C2 of the
   first, middle and last iteration held to the plain walk; no stack
   clamp).  Each image finite and within rtol = atol = 2e-3 of the render
   with every wrapper swapped for its plain version (the share of pixels
   off printed), paths/s (best of 3 warm renders), the device time by op
   and each curve kernel's time a launch beside its bound.

15. Glass through render.render: tools/caustic_scenes.caustic_only()'s
   geometry (a smooth glass sphere over a matte floor, two point lights)
   at 200x200, depth 5, Sobol': path at 16 spp (the file's spatial light
   selection: K1 2, K5 6, K4 5), whitted and directlighting (one light by
   power) at 4 spp (K1 6, K5 5, K4 10 and 5).  Every K1, K4 and K5 launch
   held to its plain version (K1 bit-equal, K4 equal, K5 as in phase 6),
   each image to the render with every wrapper swapped for its plain
   version at rtol = atol = 2e-3.
16. SPPM through render.render: caustic_only() and caustic_hair() at
   their own settings (200x200, 16 iterations, depth 5, one photon a pixel
   an iteration, the random sampler), timed as bench.py:336-341 times
   them (a warm render of 2 iterations, then the timed render; SPPM
   rays/s = w h iterations 2 / wall), the counters zeroed just before the
   timed render and read just after (S1 16, K5 160, K4 80; C3 160 and C4 80
   for the hair).  Every S1 launch of that run held to the plain deposit
   (ops/sppm_kernel.deposit_plain) on the same inputs: m bit-equal, phi
   bit-equal (on hair visible points, if not, within rtol 1e-5, atol 1e-7;
   the line says which); its time on the card (queued replays), by events,
   the plain version's and its bound; each image against the plain render
   at rtol = atol = 2e-3; grid_bucket_overflow and the final max_ev; the
   card's busy share over a profiled render of 2 iterations.  Then one
   iteration of caustic_only at 1024x1024 with 2^20 photons and the scan's
   depth at 64: its S1 launch against the plain deposit, its time queued and
   by events, its bound, the plain version's time.
17. BASELINE config 4 through render.render:
   tools/sss_scenes.sss_dragonette() (a subsurface sphere on a matte floor,
   two point lights) at 200x200, depth 6, Sobol'.  Volpath at 512 spp in
   batches of 2^22 paths after a warm render of 8 spp (bench.py:288-306):
   the launch counts (19 dims a bounce, more than K1's 128 for 7 bounces:
   K1 8, K5 35, K4 14 a batch), camera paths/s, peak device memory, the
   card's busy share over a profiled render of 8 spp.  Then volpath and
   path at 16 spp (path: K1 2, K5 31, K4 12), every K1, K4 and K5 launch
   held to its plain version (K1 bit-equal, K4 equal, K5 as in phase 6) and
   each image to the render with every wrapper swapped for its plain
   version at rtol = atol = 2e-3; paths/s (best of 3 warm renders).
18. tools/sss_scenes.smoke_dragonette(): the same scene with the camera in a
   heterogeneous medium of a 128^3 grid, volpath at 200x200, 16 spp: K1 8,
   K5 35, K4 14, M1 7, M2 7; every M1 and M2 launch held to its plain
   version (ops/medium_kernel.py delta_track_plain, ratio_track_plain:
   sampled equal, the rest bit-equal or, if not, within rtol = atol = 1e-5;
   the line says which), timed queued and by events beside its bound (the
   plain version's steps, lookups and distinct voxels on the same inputs)
   and the plain version's time; K1, K4, K5 and the image as in phase 17.

19. tools/env_scenes.quadric_env() (a ground disk, a cylinder clipped to
   270 degrees, a mirror sphere and a box, an annulus and a thin cylinder
   area light, a 1024x2048 sky map as the infinite light) through
   render.render at 256x256, depth 5: path, directlighting ("all" and
   "one") and whitted at 64 spp, ao (64 samples) and volpath at 16 spp,
   SPPM of 4 iterations.  The counters are zeroed just before each render
   and read just after: K1, K4 and K5 as each integrator draws and casts
   (path: K1 2, K5 6, K4 5; SPPM also S1 once an iteration), K2 never
   (mega_cfg refuses quadrics and an environment).  Each image finite and
   within rtol = atol = 2e-3 of the render with every wrapper swapped for
   its plain version; paths/s (SPPM rays/s) best of 3 warm renders and
   the peak device memory of each; the device time by op and the busy
   share over one path render, with the device time of the quadric tests
   and records and of the sky's sampling, pdf and lookup on escape, each
   timed in a profiler range around its function.  Then sample_distribution_2d at 2^22
   lanes on the sky: its time a call and the most memory it holds above
   its inputs (a row a lane would be 34 GB).
20. tools/env_scenes.statue_env(): phase 9's statue and BVH (the same
   triangles) under the sky, through render's defaults at 1024x1024, 16
   spp (16.7M paths, regeneration through 2^21 lanes): K1 2, B1 = B2 =
   the iterations, no stack overflow; paths/s, peak device memory, and
   the busy share over a profiled render of 4 spp.  Then a 128x128 crop's
   2^18 paths through the regeneration loop at 2^14 lanes, every path
   within rtol 1e-5, atol 1e-6 of the fixed-depth loop's.  It runs right
   after phase 10, so that phase 9's statue is freed before phase 11 and
   no later phase's peak memory holds it.

21. tools/material_scenes.material_grid() (nine spheres and a box of
   plastic, copper, substrate, a five-lobe uber, translucent, three Disney
   materials, a mix of plastic and copper, and the Fourier lobe on a
   64-node glossy table, on a matte ground under an area light and the
   1024x2048 sky) through render.render at 256x256, depth 5: path,
   directlighting ("all") and whitted at 64 spp, volpath at 16 spp, SPPM
   of 4 iterations.  The counters are zeroed just before each render and
   read just after (the counted render is each integrator's first, the
   timed ones follow it); they must equal the counts of the same render on the
   CPU at 8x8 (every wrapper swapped for one that counts its calls and
   runs the plain version): K1, K4, K5, S1 (SPPM: its general visible
   points through csrc/bxdf.cuh), F1 and F2, K2 never.  Each image finite
   and within rtol = atol = 2e-3 of the render with every wrapper swapped
   for its plain version; paths/s (SPPM rays/s) best of 3 warm renders,
   peak device memory; the busy share of one profiled path render with
   the device time in make_bsdf_at, bsdf_f, bsdf_pdf, bsdf_sample, F1 and
   F2 (profiler ranges; bsdf_sample's holds its own bsdf_f and bsdf_pdf).
   Then every F1 and F2 launch of the path render against its plain
   version (bit-equal, else within 1e-5, the line says which), timed
   queued and by events beside its bound (the orders each lane's sums
   take) and the plain version's time.
22. tools/material_scenes.statue_disney(): phase 9's statue and BVH in a
   Disney material with clearcoat and sheen (lobe slots 0-3 on every
   statue hit), through render's defaults at 1024x1024, 16 spp
   (regeneration through 2^21 lanes): K1 2, B1 = B2 = the iterations;
   paths/s, peak memory, the busy share of a profiled 4 spp render; then
   the 128x128 crop's 2^18 paths through the regeneration loop at 2^14
   lanes, each within rtol 1e-5, atol 1e-6 of the fixed-depth loop.  It
   runs right after phase 20, before phase 9's statue is freed.

Then one JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
"""

from __future__ import annotations

import io
import json
import re
import subprocess
import sys
import time
from contextlib import ExitStack, redirect_stdout
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
TOL = 2e-3  # K2-K5 and the renders against their plain versions (rtol = atol)
DEVICE = "cuda"
# the main paths' size: 256x256 at 64 spp in one batch, depth 5
RES, SPP, DEPTH = (256, 256), 64, 5
# phase 3: (index bits, lanes, dim0, n_dims); 22 and 19 bits are the
# render paths' exact widths (256x256 at 64 and 8 spp)
K1_CASES = ((32, 1 << 22, 0, 5), (52, 1 << 22, 0, 5), (22, 1 << 22, 0, 5), (22, 1 << 22, 7, 1),
            (19, 1 << 19, 5, 35), (22, 1 << 18, 5, 128), (52, 1 << 18, 1024 - 128, 128))
K2_SPP = 4  # phase 4
# phase 9: the statue at the size bench.py:228-249 renders it
STATUE_SUBDIV, STATUE_RES, STATUE_SPP = 8, (256, 256), 8
B2_TAIL_RAYS = (1 << 14) + 5  # phase 9: B2 on a launch cut to this many rays
PROBE_SHAPE = (16, 2048)  # phase 8: P1 and P2 at the JAX probe's shape
REGEN_CHECK_WIDTH = 1 << 14  # phase 10: the lane pool of the refill check
CROP = (0.25, 0.75, 0.1, 0.6)  # phase 11: the crop window (x0, x1, y0, y1)
# phase 12: the statue at the size bench.py:252-277 renders it
FULL_SUBDIV, FULL_RES, FULL_SPP = 9, (1024, 1024), 64
# phases 13-14: the curve kernels' inputs and the hair renders
BOUND_SAMPLE_RAYS = 1 << 16  # phase 12: the rays of a launch its bound is counted on
CURVE_RAYS = 1 << 18  # random rays against the fur tree, the 48 and the 1024 rows
CURVE_TABLE_ROWS = 1024  # C3/C4's largest table (scene_intersect.BRUTE_FORCE_MAX_CURVES)
FUR_FIBERS = 8192  # 262,144 segments
FUR_LANE_WIDTH = 1 << 18  # the fur render's regeneration lanes: its 640,000 paths
#                           are below the default REGEN_LANE_WIDTH

# published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
K1_OPS_PER_STEP = 2  # K1: an AND and an XOR per (index bit, dim)
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
ALIVE_BYTES = 4  # every lane's alive flag, read
LIVE_LANE_BYTES = 13 * 4 * 2 + 4  # a live lane's 13 f32 rows in and out, its alive out
# K2 and B1 as they were before their redesign (one thread a lane, one
# thread a ray), from this script on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md): K2's times per launch in the flagship render (CUDA events; the
# card is busy there, so they are its device time); B1's per launch in the
# statue render as the events around each call timed them (the render is
# host-bound, so they hold the wrapper's host time too), and its device
# time over those six launches from the profiler
PREV_K2_MS = (1.536, 1.508, 1.514, 1.516, 0.994, 0.464)
PREV_B1_MS = (0.841, 1.381, 0.984, 0.713, 0.363, 0.299)
PREV_B1_DEVICE_MS = 3.552
# K1 (one thread a lane, row-major stores, 32-bit index, at most 64 dims a
# launch) and B2 (one thread a ray) as they were before their redesign:
# each launch of these renders on the card alone, queued
# (rs_pbrt_tpu_torch/tools/k1_b2_replay.py --root on the earlier checkout,
# NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md)
PREV_K1_DEVICE_MS = dict(flagship=(0.1520,),
                         directlighting=(0.1489, 0.1540, 0.1539, 0.1541, 0.1539, 0.1541),
                         whitted=(0.1490, 0.1538, 0.1540, 0.1538, 0.1540, 0.1540),
                         statue=(0.0214, 0.3564))
PREV_B2_DEVICE_MS = (0.6459, 0.3370, 0.2343, 0.1268, 0.0572)
# K3 and K4 as they were before their redesign (one thread a ray, the table
# read through the read-only cache, the one-hot form): each launch of the
# slice 2 renders and phase 6's inputs on the card alone, queued
# (rs_pbrt_tpu_torch/tools/sweep_replay.py --root on the earlier checkout,
# NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md)
PREV_K3_DEVICE_MS = {"camera": 0.1169, "random": 2.7449, "mixed": 0.4075,
                     "mixed without NaN": 0.4053}
# P1 and P2 as they were before their redesign (each block staged its row,
# the generic remainder, random banks): at (16, 2048) on the card alone
# (rs_pbrt_tpu_torch/tools/probe_replay.py --root on the earlier checkout,
# NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md)
PREV_PROBE_MS = {"take_rows": 0.0050, "take_loop": 0.0584}
PREV_K4_DEVICE_MS = {
    "directlighting": (0.0932, 0.0928, 0.0927, 0.0927, 0.0923, 0.0926, 0.0924, 0.0927, 0.0924,
                       0.0925),
    "whitted": (0.0928, 0.0930, 0.0928, 0.0925, 0.0925, 0.0926, 0.0925, 0.0923, 0.0925, 0.0924),
    "camera": 0.0740, "random": 2.4800, "mixed": 0.3535, "mixed without NaN": 0.3524,
}
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
# B1/B2's f32 arithmetic, counted as ISECT_FLOP is in csrc/bvh12.cu
BVH_FLOP = dict(
    ray=6,  # 1/d (3), 1/d[kz], sx, sy
    slab=13,  # per child box: 6 subtractions, 6 multiplications, tf * eps
    tri=65,  # per triangle: the SoA watertight test with its error bound
)
ROW_BYTES = 512  # one wide12 row
# C1-C4's f32 arithmetic, counted in csrc/curve.cuh and csrc/curves.cu
CURVE_FLOP = dict(
    ray=15,  # make_ray: |d| and d / |d|
    inv_d=3,  # the walk's 1 / d
    slab=13,  # per child box the walk tests: 6 sub, 6 mul, t_far * eps
    test=272,  # seg_test, per (ray, segment) test
)
CURVE_ROW_BYTES = 26 * 4  # one segment row
CURVE_NODE_BYTES = 2 * 4 + 12 * 4  # a node's two child refs and two boxes
CURVE_OUT_BYTES = 5 * 4  # t, seg, w, u, v (C1, C3); the any hits write one byte
# phases 15-16: BASELINE config 5 (rs_pbrt_tpu_torch/tools/caustic_scenes.py)
GLASS_RES = (200, 200)  # phase 15: the caustic scene's geometry with path and Sobol'
GLASS_RUNS = (("path", 16), ("whitted", 4), ("directlighting", 4))  # (integrator, spp)
SPPM_RES = (200, 200)  # phase 16: both scenes at their own settings
SPPM_WARM_ITERATIONS = 2  # bench.py:336-341: a warm render of 2 iterations, then the timed one
DEPOSIT_RES = (1024, 1024)  # phase 16: one iteration's deposit of 2^20 photons
# S1's f32 arithmetic, counted in csrc/sppm.cu as CURVE_FLOP is: per tested
# (VP, event) pair the cell compare and the distance test; per near pair
# the frame's three dots and the sums, plus its lobe's f (the hair lobe's
# with its Bessel series of the small-variance lobes)
S1_FLOP = dict(test=9, near=22, lambert=3, oren_nayar=17, hair=272)
S1_ROW_BYTES = 11 * 4  # one packed event row
# per VP: the 27 neighbours' first row, flag and id in; p, frame, wo, r2 and
# color, the lobe tag and its 44 wo terms in; phi and m out
S1_VP_BYTES = 27 * (8 + 1 + 4) + 19 * 4 + 4 + 44 * 4 + 16
# phases 17-18: BASELINE config 4 (rs_pbrt_tpu_torch/tools/sss_scenes.py)
SSS_RES = (200, 200)  # the file's film
SSS_WARM_SPP = 8  # bench.py:288-306: a warm render of 8 spp, then 512 spp in batches of 2^22
SSS_CHECK_SPP = 16  # the renders held to their plain renders (the file's spp)
SMOKE_GRID_RES = 128  # phase 18: the smoke's (128, 128, 128) f32 grid, 8 MB
# M1 and M2's operations, counted in csrc/medium.cu as K2_FLOP is: a step
# draws its uniforms (a hash of 39 integer operations each: two combines of
# 14, the finalizer's 8, the conversion), takes 1 - u, its log (1) and the
# distance (2); a lookup (a step not past the segment) forms its point (6),
# transforms it (24) and divides (3), finds its voxel (12), weighs and sums
# 8 taps (35) and divides by the largest density (1); M2 adds its product
# and its clamp (2)
# phase 19: tools/env_scenes.quadric_env at BASELINE config 2's width
ENV_RES = (256, 256)
ENV_SKY_HW = (1024, 2048)  # the sky map (env_scenes.SKY_HW)
# (tag, integrator, spp, extra); depth DEPTH; sppm's spp is its iterations
ENV_RUNS = (("path", "path", 64, None),
            ("directlighting all", "directlighting", 64, dict(strategy="all")),
            ("directlighting one", "directlighting", 64, dict(strategy="one")),
            ("whitted", "whitted", 64, None),
            ("ao", "ao", 16, dict(n_samples=64)),  # the .pbrt default (api.rs make_integrator)
            ("volpath", "volpath", 16, None),
            ("sppm", "sppm", 4, dict(n_iterations=4)))
SEARCH_LANES = 1 << 22  # phase 19: sample_distribution_2d's lanes on the 1024x2048 sky
# phase 20: the statue under the sky through render's defaults (regeneration)
STATUE_ENV_RES, STATUE_ENV_SPP = (1024, 1024), 16
STATUE_ENV_PROFILE_SPP = 4  # the profiled render: 4M paths, above one lane width
STATUE_ENV_CROP = (128, 128)  # with 16 spp, 2^18 paths against the fixed-depth loop
# phase 21: tools/material_scenes.material_grid at BASELINE config 2's width
GRID_RES = (256, 256)
# (tag, integrator, spp, extra); depth DEPTH; sppm's spp is its iterations
GRID_RUNS = (("path", "path", 64, None),
             ("directlighting all", "directlighting", 64, dict(strategy="all")),
             ("whitted", "whitted", 64, None),
             ("volpath", "volpath", 16, None),
             ("sppm", "sppm", 4, dict(n_iterations=4)))
# F1 and F2's operations (ops/fourier_bsdf.py, counted as the bounds
# below count): F1's lane: its weights, cos phi, transform and pdf (~120);
# an order of its sums: 3 channels x 16 taps x 2 and the recurrence
# (~100); F2's lane: the 4-row interpolation's search, 12 Newton steps and
# the direction (~600) plus each cdf entry's interpolation (8); an order of
# its luminance taps and 20 Newton steps of the sine/cosine recurrence
# (~32 + 20 x 8)
F_FLOP = dict(lane=120, order=100, sample_lane=600, cdf_entry=8, sample_order=192)
M_FLOP = dict(delta_step=83, ratio_step=44, delta_lookup=81, ratio_lookup=83)
M_RAY_BYTES = 4 + 1 + 12 + 12 + 4 + 4  # mid, in_med, o, d, t_max or dist, the lane key
M_OUT_BYTES = dict(delta_track=1 + 4 + 12, ratio_track=4)  # sampled, t, weight; tr
SMEM_LOADS_PER_CLOCK = 32  # shared-memory loads per clock per SM
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


def queued_ms(fn, reps: int) -> float:
    """Device time of fn() per call, reps calls queued behind a sleeping
    kernel (rs_pbrt_tpu_torch/tools/k1_b2_replay.queued_ms); cuda_ms times
    calls as the host makes them, so a kernel shorter than the host's cost
    of a call reads as that cost.  Fails if the sleep ended before the host
    had queued every call."""
    from rs_pbrt_tpu_torch.tools import k1_b2_replay

    try:
        return k1_b2_replay.queued_ms(fn, reps)
    except RuntimeError as e:
        fail(str(e))


class LaunchTimer:
    """Wraps a kernel wrapper (or its plain version) to record CUDA events
    around every call, keeping the call's arguments (and with keep, its
    outputs) for the checks and the bound.  copy: keep copies of the tensor
    arguments taken before the call and of the outputs taken after it, for a
    wrapper that updates its arguments in place (K2)."""

    def __init__(self, fn, keep: bool = False, copy: bool = False):
        import torch

        self.fn, self.torch, self.keep, self.copy, self.calls = fn, torch, keep, copy, []

    def _copied(self, xs):
        return tuple(x.clone() if self.torch.is_tensor(x) else x for x in xs)

    def __call__(self, *args, **kw):
        kept = self._copied(args) if self.copy else args
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.fn(*args, **kw)
        ev[1].record()
        kept_out = None
        if self.keep:
            kept_out = self._copied(out) if self.copy else out
        self.calls.append((ev, kept, kw, kept_out))
        return out

    def times_ms(self):
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for (s, e), _, _, _ in self.calls]


def k2_bound_ms(work, args, kw):
    """Least time of one bounce launch on these inputs, as (bytes_ms,
    operations_ms); the bound is the larger.  work: the lane counts of each
    step, from bounce_plain on the same inputs.  Bytes, as the function
    needs them whatever implements it: every lane's alive flag; each live
    lane's 13 rows in and out and its alive out; the index of the lanes that
    draw Sobol' samples; the tables the launch reads, once.  Operations:
    K2_FLOP per step times its lanes."""
    lanes, _alive, _index, tables, cfg = args
    f, w = K2_FLOP, work
    flop = w["live"] * (f["ray"] + cfg.n_tri * f["tri_closest"])
    flop += w["hit"] * (f["hit"] + (f["emit_first"] if kw["first_bounce"] else f["emit_mis"]))
    flop += w["hit_normals"] * f["hit_normals"]
    row = tables.tris.shape[1] * 4
    nbytes = (lanes.shape[1] * ALIVE_BYTES + w["live"] * LIVE_LANE_BYTES + cfg.n_tri * row
              + tables.lattr.numel() * 4 + tables.lsel.numel() * 4)
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
    from rs_pbrt_tpu_torch.ops import bvh
    from rs_pbrt_tpu_torch.ops import curve_kernel as ck
    from rs_pbrt_tpu_torch.ops import fourier_kernel as fk
    from rs_pbrt_tpu_torch.ops import gather_probe as gp
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import medium_kernel as mk
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.ops import sppm_kernel as sd

    return sk, pk, ik, bvh, gp, ck, sd, mk, fk


def zero_counts():
    """Every kernel's launch count to 0."""
    sk, pk, ik, bvh, gp, ck, sd, mk, fk = _kernel_modules()
    sk.launches = pk.launches = 0
    for d in (ik.launches, bvh.launches, gp.launches, ck.launches, sd.launches, mk.launches,
              fk.launches):
        d.update(dict.fromkeys(d, 0))


def read_counts() -> dict:
    sk, pk, ik, bvh, gp, ck, sd, mk, fk = _kernel_modules()
    return dict(sobol=sk.launches, bounce=pk.launches, **ik.launches,
                **{f"bvh12_{k}": v for k, v in bvh.launches.items()}, **gp.launches,
                **ck.launches, **sd.launches, **mk.launches, **fk.launches)


def expect_counts(**launched) -> dict:
    """The counts of a run that launches only the kernels named."""
    return {**dict.fromkeys(read_counts(), 0), **launched}


def _owner(name: str):
    """The module of the kernel wrapper `name` (sobol_dims, bounce,
    closest_sweep, any_sweep, full_sweep, bvh12_intersect_tris, take_rows,
    take_loop, walk_closest, walk_any, sweep_closest, sweep_any, deposit,
    delta_track, ratio_track, fourier_eval, fourier_sample)."""
    sk, pk, ik, bvh, gp, ck, sd, mk, fk = _kernel_modules()
    return dict(sobol_dims=sk, bounce=pk, closest_sweep=ik, any_sweep=ik, full_sweep=ik,
                bvh12_intersect_tris=bvh, take_rows=gp, take_loop=gp, walk_closest=ck,
                walk_any=ck, sweep_closest=ck, sweep_any=ck, deposit=sd, delta_track=mk,
                ratio_track=mk, fourier_eval=fk, fourier_sample=fk)[name]


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
    """Fails unless a sweep launch matches its plain version
    (tools/sweep_replay.compare: K4 equal; K3 tri ids equal, t, b0, b1
    within TOL; K5 prim, mat, light equal, its 18 rows within TOL).  Returns
    the largest absolute difference."""
    from rs_pbrt_tpu_torch.tools import sweep_replay

    why, err = sweep_replay.compare(kind, got, want)
    if why:
        fail(f"{what}: {why} from the plain version")
    return err


def k1_bound_ms(n: int, n_dims: int, n_bits: int) -> tuple:
    """Least time of one K1 launch, as (bytes_ms, operations_ms): 8 bytes
    of index in and 4 per dim out per lane, over the memory rate; one AND
    and one XOR per index bit below the index's width and per dim, over the
    32-bit rate."""
    return (1e3 * n * (8 + 4 * n_dims) / HBM_BYTES_PER_S,
            1e3 * n * n_bits * n_dims * K1_OPS_PER_STEP / FP32_FLOP_PER_S)


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


def ptxas_resources(log: str) -> list:
    """(source, kernel, registers, shared-memory bytes, stack-frame bytes)
    of each entry function in nvcc -Xptxas -v output."""
    found, name, frame = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, frame = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            frame = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            # anonymous-namespace kernels: _ZN<n>_GLOBAL__N__<hash>_<n>_<file>_cu_<hash><n><kernel>E..
            k = re.search(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}(\d+)", name)
            src, kernel = (k.group(1) + ".cu", name[k.end():k.end() + int(k.group(2))]) if k \
                else ("?", name)
            # a template's bool arguments: I Lb0E Lb1E .. E
            targs = re.match(r"I((?:Lb[01]E)+)E", name[k.end() + int(k.group(2)):]) if k else None
            if targs:
                kernel += "<" + ", ".join("true" if b == "1" else "false"
                                          for b in re.findall(r"Lb([01])E", targs.group(1))) + ">"
            found.append((src, kernel, int(m.group(1)), int(m.group(2) or 0), frame))
            name = None
    return found


def phase_build():
    from rs_pbrt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log = io.StringIO()
    with redirect_stdout(log):
        out = _build.build_all(verbose=True)
    print(log.getvalue(), end="")
    print(f"[2 build] {sorted(p.name for p in out.glob('*.so'))} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    for src, kernel, regs, smem, frame in ptxas_resources(log.getvalue()):
        print(f"[2 ptxas] {src} {kernel}: {regs} registers, {smem} bytes static shared memory, "
              f"{frame} bytes stack frame", flush=True)


def phase_k1(card):
    """Phase 3: K1 bit-equal to its plain version, with the same strides, on
    random indices below 2^bits at the K1_CASES; its time on the card
    (queued) beside the bound.  Returns the largest difference."""
    import numpy as np
    import torch

    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk

    rng = np.random.default_rng(1)
    worst = 0.0
    for bits, n, dim0, n_dims in K1_CASES:
        index = torch.as_tensor(rng.integers(0, 1 << bits, n, dtype=np.int64), device=DEVICE)
        want = sk.sobol_dims_plain(index, dim0, n_dims, bits)
        got = sk.sobol_dims(index, dim0, n_dims, bits)
        torch.cuda.synchronize()
        worst = max(worst, float((got - want).abs().max()))
        if not torch.equal(got, want) or got.stride() != want.stride():
            fail(f"K1 {bits}-bit, dims {dim0}..{dim0 + n_dims - 1}: {int((got != want).sum())} "
                 f"of {got.numel()} values differ from the plain version (strides "
                 f"{got.stride()}, plain {want.stride()})")
        ms = queued_ms(lambda: sk.sobol_dims(index, dim0, n_dims, bits), 20)
        bms, fms = k1_bound_ms(n, n_dims, bits)
        print(f"[3 K1] {bits}-bit index, {n} lanes x dims {dim0}..{dim0 + n_dims - 1}: bit-equal "
              f"to the plain version; {ms:.4f} ms on the card, bound {max(bms, fms):.4f} ms "
              f"(bytes {bms:.4f}, operations {fms:.4f}) ({card})", flush=True)
        del index, want, got
    return worst


def phase_k2(card, scene, camera):
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.tools import k2_replay

    cfg = pk.mega_cfg(scene)
    tables = pk.mega_tables(scene)
    scfg = smpl.make_sampler(smpl.SOBOL, K2_SPP, camera.resolution)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, K2_SPP)
    index, bits = ctx.global_index, smpl.index_bits(scfg)
    lanes, alive = pk.init_lanes(rays.o, rays.d)
    kw = dict(dim_row=pathmod.DIM_CAMERA, n_bits=bits, first_bounce=True, rr_active=False,
              emit_only=False, rr_threshold=1.0)
    ekw = dict(kw, dim_row=0, first_bounce=False, emit_only=True)
    if not tables.finite_verts:
        fail("the Cornell box's triangle table holds a non-finite vertex")
    worst = 0.0
    for step, args in (("bounce", kw), ("emit-only", ekw)):
        want = pk.bounce_plain(lanes, alive, index, tables, cfg, **args)
        # both forms of the kernel's sweeps: the shear picked by index (a
        # table of finite vertices, as here) and the one-hot form; the kernel
        # updates its copy of the lane state in place
        for form, tab in (("index", tables), ("one-hot", tables._replace(finite_verts=False))):
            got = pk.bounce(lanes.clone(), alive.clone(), index, tab, cfg, **args)
            err = check_k2_launch(f"K2 {step} ({form} form)", got, want)
            worst = max(worst, err)
            print(f"[4 K2] {step}, {lanes.shape[1]} lanes, {form} form: o, d, beta, L, prev_pdf "
                  f"within {TOL} (max abs err {err:.3g}), alive equal", flush=True)
        lanes, alive = want

    # a table near K2's largest, which its sweeps read from device memory
    calls = k2_replay.record_launches(*k2_replay.curtain_scene(RES, device=DEVICE), K2_SPP)
    c_ms = []
    for b, call in enumerate(calls):
        err = check_k2_launch(f"K2 curtain launch {b}",
                              pk.bounce(call[0].clone(), call[1].clone(), *call[2:5], **call[5]),
                              pk.bounce_plain(*call[:5], **call[5]))
        worst = max(worst, err)
        c_ms.append(k2_replay.replay_ms(call))
    print(f"[4 K2] curtain, {call[3].tris.shape[0]} triangles, {len(calls)} launches of "
          f"{call[0].shape[1]} lanes: o, d, beta, L, prev_pdf within {TOL} (max abs err "
          f"{worst:.3g}), alive equal; {', '.join(f'{t:.4f}' for t in c_ms)} ms, live lanes "
          f"{[int(c[1].sum()) for c in calls]} ({card})", flush=True)
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


def _ranged(label: str, fn):
    """fn inside a torch.profiler.record_function range named label."""
    from torch.profiler import record_function

    def run(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)
    return run


def profile_render(go, tag: str, top: int = 12, ranges=None):
    """Device time by op over one warm render (torch.profiler), and the
    device's busy share of that render's wall time.  ranges maps a label
    to (module, function name): that function runs in a record_function
    range of the label for the render, and each label's device time (the
    kernels launched inside the range) is printed beside the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ranges = ranges or {}
    torch.cuda.synchronize()
    with ExitStack() as stack:
        for label, (module, name) in ranges.items():
            stack.enter_context(mock.patch.object(module, name,
                                                  _ranged(label, getattr(module, name))))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # device-side events only (kernels, copies): a CPU op's entry repeats
    # the device time of the kernels it launched, and a range's device-side
    # entry spans its kernels and the gaps between them
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in events
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0
            and e.key not in ranges]
    busy = sum(r[0] for r in rows)
    print(f"[{tag}] device busy {busy:.3f} ms of a {wall_ms:.3f} ms profiled render "
          f"({100 * busy / wall_ms:.1f}%); {len(rows)} device ops, the top {top}:", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        print(f"[{tag}]   {ms:9.3f} ms {count:6d}x  {key[:90]}")
    for label, (module, name) in ranges.items():
        hits = [e for e in events if e.key == label and "CPU" in str(e.device_type)]
        ms = sum(e.device_time_total for e in hits) / 1e3
        calls = sum(e.count for e in hits)
        share = 100 * ms / max(busy, 1e-9)
        print(f"[{tag}]   range {label!r} ({module.__name__.rsplit('.', 1)[-1]}.{name}): "
              f"{ms:.3f} ms of device time in {calls} calls, {share:.1f}% of the busy time",
              flush=True)
    return rows


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
    k1r = LaunchTimer(sk.sobol_dims, keep=True)
    k2r = LaunchTimer(pk.bounce, keep=True, copy=True)
    with ExitStack() as es:
        es.enter_context(mock.patch.object(sk, "sobol_dims", k1r))
        es.enter_context(mock.patch.object(pk, "bounce", k2r))
        zero_counts()
        img = go()
        torch.cuda.synchronize()
        counts = read_counts()
    want = expect_counts(sobol=1, bounce=depth + 1)
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
    k1_bound = k1_bound_ms(k1_args[0].shape[0], *k1_args[2:4])
    # K1's device time: the launch's recorded inputs replayed, queued
    k1_dev = queued_ms(lambda: sk.sobol_dims(*k1_args, **k1_kw), 20)
    k2_err, k2_parts, k2_work = 0.0, [], []
    for b, (_, args, kw, out) in enumerate(k2r.calls):
        work = {}
        want = pk.bounce_plain(*args, **kw, work=work)
        k2_err = max(k2_err, check_k2_launch(f"flagship K2 launch {b}", out, want))
        k2_parts.append(k2_bound_ms(work, args, kw))
        k2_work.append(work)
    k2_live = [w["live"] for w in k2_work]
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
    print(f"[5 render] K1 per launch {k1_ms:.4f} ms (on the card {k1_dev:.4f} ms, bound "
          f"{max(k1_bound):.4f} ms; recorded, not measured here: the one-thread-a-lane kernel "
          f"{PREV_K1_DEVICE_MS['flagship'][0]:.4f} ms on the card); K2 per launch "
          f"{', '.join(f'{t:.3f}' for t in k2_ms)} ms (bounds "
          f"{', '.join(f'{b:.4f}' for b in k2_bounds)} ms); plain render K1 "
          f"{p1t.times_ms()[0]:.3f} ms, K2 {', '.join(f'{t:.1f}' for t in p2_ms)} ms", flush=True)
    for b, (t, bound, live) in enumerate(zip(k2_ms, k2_bounds, k2_live)):
        old = PREV_K2_MS[b] if b < len(PREV_K2_MS) else float("nan")
        print(f"[5 K2] launch {b}: {live} live lanes, {t:.4f} ms, bound {bound:.4f} ms, "
              f"{100 * bound / t:.1f}% of it ({card}); recorded, not measured here: the "
              f"one-thread-a-lane kernel {old:.3f} ms, {100 * bound / old:.1f}%", flush=True)
    print(f"[5 K2] all launches {sum(k2_ms):.4f} ms, bounds {sum(k2_bounds):.4f} ms ({card}); "
          f"recorded: the one-thread-a-lane kernel {sum(PREV_K2_MS):.3f} ms", flush=True)
    return dict(
        counts=counts, err=err,
        k1=dict(ms=[k1_ms], device_ms=[k1_dev], plain_ms=p1t.times_ms(), bound=[k1_bound],
                max_abs_err=k1_err),
        k2=dict(ms=sum(k2_ms) / len(k2_ms), plain_ms=sum(p2_ms) / len(p2_ms),
                bound_ms=sum(k2_bounds) / len(k2_bounds), bound_by=k2_by, max_abs_err=k2_err),
    )


def phase_sweeps(card):
    """Phase 6: K3, K4, K5 against their plain versions, timed (events
    around calls as the host makes them, and on the card alone: device_ms,
    queued), with their bounds, on tools/sweep_replay.sweep_inputs.
    Returns, per kind, the camera rays' numbers and the worst error."""
    import torch

    from rs_pbrt_tpu_torch.tools import sweep_replay

    out = {}
    for name, args in sweep_replay.sweep_inputs(DEVICE).items():
        for kind, kid, fn, plain in sweep_replay.sweep_kernels():
            got = fn(*args)
            err = check_isect(f"{kid} {name}", kind, got, plain(*args))
            ms = cuda_ms(lambda: fn(*args), 20)
            dev_ms = queued_ms(lambda: fn(*args), 20)
            plain_ms = cuda_ms(lambda: plain(*args), 2)
            bms, fms = isect_bound_ms(kind, args, got)
            hits = float((got if kind == "any" else got.valid).float().mean())
            prev = dict(K3=PREV_K3_DEVICE_MS, K4=PREV_K4_DEVICE_MS).get(kid, {}).get(name)
            was = (f"; recorded, not measured here: the one-thread-a-ray kernel {prev:.4f} ms on "
                   "the card" if prev is not None else "")
            print(f"[6 {kid}] {name}: {args[0].shape[0]} rays x {args[4]} triangles, "
                  f"{100 * hits:.1f}% hit; matches the plain version (max abs err {err:.3g}); "
                  f"kernel {dev_ms:.4f} ms on the card, {ms:.4f} ms by events, plain "
                  f"{plain_ms:.3f} ms, bound {max(bms, fms):.4f} ms (bytes {bms:.4f}, operations "
                  f"{fms:.4f}), {100 * max(bms, fms) / dev_ms:.1f}% of it ({card}){was}",
                  flush=True)
            if name == "camera":  # the main paths' shape
                out[kind] = dict(ms=[ms], device_ms=[dev_ms], plain_ms=[plain_ms],
                                 bound=[(bms, fms)], max_abs_err=err)
            out[kind]["max_abs_err"] = max(out[kind]["max_abs_err"], err)
            del got
        del args
    torch.cuda.synchronize()
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
    want = expect_counts(sobol=1 + depth, any_sweep=depth * scene.n_lights, full_sweep=depth)
    if counts != want:
        fail(f"launch counts of the {integrator} render {counts}, expected {want}")
    if tuple(img.shape) != (res[1], res[0], 3) or not torch.isfinite(img).all():
        fail(f"{integrator} image: shape {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")

    # each launch of that run against its plain version on the same inputs
    errs = dict(sobol_dims=0.0, any_sweep=0.0, full_sweep=0.0)
    bounds = {k: [] for k in names}
    k1_dev = []  # each K1 launch's device time: its inputs replayed, queued
    for b, (_, args, kw, out) in enumerate(rec["sobol_dims"].calls):
        want_k1 = sk.sobol_dims_plain(*args, **kw)
        torch.cuda.synchronize()
        errs["sobol_dims"] = max(errs["sobol_dims"], float((out - want_k1).abs().max()))
        if not torch.equal(out, want_k1):
            fail(f"{integrator} K1 launch {b} differs from its plain version")
        bounds["sobol_dims"].append(k1_bound_ms(args[0].shape[0], *args[2:4]))
        k1_dev.append(queued_ms(lambda a=args, k=kw: sk.sobol_dims(*a, **k), 20))
    dev = {"any_sweep": [], "full_sweep": []}  # each K4, K5 launch replayed, queued
    for key, kind, kid, plain in (("any_sweep", "any", "K4", ik.any_sweep_plain),
                                  ("full_sweep", "full", "K5", ik.full_sweep_plain)):
        for b, (_, args, kw, out) in enumerate(rec[key].calls):
            errs[key] = max(errs[key], check_isect(f"{integrator} {kid} launch {b}", kind, out,
                                                   plain(*args, **kw)))
            bounds[key].append(isect_bound_ms(kind, args, out))
            dev[key].append(queued_ms(lambda a=args, k=kw, f=wrapper(key): f(*a, **k), 20))
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
    prev = PREV_K1_DEVICE_MS[integrator]
    print(f"[{tag}] K1 per launch on the card {', '.join(f'{t:.4f}' for t in k1_dev)} ms "
          f"= {sum(k1_dev):.4f} ms ({card}); recorded, not measured here: the "
          f"one-thread-a-lane kernel {', '.join(f'{t:.4f}' for t in prev)} = {sum(prev):.4f} ms",
          flush=True)
    prev = PREV_K4_DEVICE_MS.get(integrator, ())
    for k, kid, was in (("any_sweep", "K4", f"; recorded, not measured here: the "
                         f"one-thread-a-ray kernel {', '.join(f'{t:.4f}' for t in prev)} = "
                         f"{sum(prev):.4f} ms" if prev else ""), ("full_sweep", "K5", "")):
        print(f"[{tag}] {kid} per launch on the card {', '.join(f'{t:.4f}' for t in dev[k])} "
              f"ms = {sum(dev[k]):.4f} ms, {100 * sum(max(b) for b in bounds[k]) / sum(dev[k]):.1f}"
              f"% of the bounds ({card}){was}", flush=True)
    out = {k: dict(ms=ms[k], plain_ms=plain_ms[k], bound=bounds[k], max_abs_err=errs[k])
           for k in names}
    out["sobol_dims"]["device_ms"] = k1_dev
    out["any_sweep"]["device_ms"] = dev["any_sweep"]
    out["full_sweep"]["device_ms"] = dev["full_sweep"]
    return dict(out, counts=counts)


def smem_loads_per_s() -> tuple:
    """(shared-memory loads/s of the whole card, its SM count), for P2's
    bound: SMEM_LOADS_PER_CLOCK on each SM at the maximum SM clock
    (nvidia-smi clocks.max.sm)."""
    import torch

    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi clocks.max.sm failed: {smi.stderr.strip()}")
    return SMEM_LOADS_PER_CLOCK * sms * float(smi.stdout.strip().splitlines()[0]) * 1e6, sms


def phase_probe(card):
    """Phase 8: the probe tool, then P1 and P2 against their plain versions
    on tools/probe_replay.probe_cases, and their times."""
    import torch

    from rs_pbrt_tpu_torch.ops import gather_probe as gp
    from rs_pbrt_tpu_torch.tools import probe, probe_replay

    zero_counts()
    res = probe.main(DEVICE)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["take_rows"] < 1 or counts["take_loop"] < 1 or \
            counts != expect_counts(take_rows=counts["take_rows"], take_loop=counts["take_loop"]):
        fail(f"launch counts of the probe {counts}: P1 and P2 only, each at least once")
    if not res["p1_equal"]:
        fail("the probe's P1 differs from its plain version")
    out = {key: dict(max_abs_err=0.0) for key in ("take_rows", "take_loop")}
    loads_per_s, sms = smem_loads_per_s()
    paths = []
    for name, rows, cols, steps in probe_replay.probe_cases():
        tab, idx = gp.probe_inputs(rows, cols, seed=probe_replay.SEED, device=DEVICE)
        pairs = (("take_rows", lambda t=tab, i=idx: gp.take_rows(t, i),
                  lambda t=tab, i=idx: gp.take_rows_plain(t, i)),
                 ("take_loop", lambda t=tab, i=idx, s=steps: gp.take_loop(t, i, s),
                  lambda t=tab, i=idx, s=steps: gp.take_loop_plain(t, i, s)))
        for key, fn, plain in pairs:
            before = gp.launches[key]
            got, want = fn(), plain()
            torch.cuda.synchronize()
            if gp.launches[key] != before + 1:
                fail(f"{name}: {key} did not launch its kernel once")
            if not torch.equal(got, want):
                fail(f"{name} ({rows}, {cols}), {steps} steps: {key} differs from its plain "
                     f"version on {int((got != want).sum())} of {got.numel()} values")
            out[key]["max_abs_err"] = max(out[key]["max_abs_err"],
                                          float((got - want).abs().max()))
        paths.append(f"{name} ({rows}, {cols}) x {steps}: "
                     f"{'power of two' if cols & (cols - 1) == 0 else 'remainder'}")
        n = tab.numel()
        if (rows, cols) == PROBE_SHAPE and steps == gp.STEPS:
            for key, fn, plain in pairs:
                reps = 200 if key == "take_rows" else 20
                out[key].update(ms=[queued_ms(fn, reps)], plain_ms=[cuda_ms(plain, 2)],
                                call_ms=cuda_ms(fn, reps))
            idx64 = idx.long()
            gather_ms = queued_ms(lambda: torch.gather(tab, 1, idx64), 200)
            gather_call_ms = cuda_ms(lambda: torch.gather(tab, 1, idx64), 200)
            floor_ms = probe_replay.launch_floor_ms(queued_ms)
            # P1: the table, the indices and the output once each, over the memory rate
            out["take_rows"]["bound"] = [(1e3 * 3 * 4 * n / HBM_BYTES_PER_S, 0.0)]
            # P2: one shared-memory load per element and step, over every SM
            out["take_loop"]["bound"] = [(0.0, 1e3 * n * steps / loads_per_s)]
        if name == "wide":
            wide = (rows, cols, steps, queued_ms(pairs[1][1], 10), 1e3 * n * steps / loads_per_s)
    p1, p2 = out["take_rows"], out["take_loop"]
    fetches = gp.STEPS * PROBE_SHAPE[1] / (p2["ms"][0] / 1e3)
    print(f"[8 probe] launches {counts}; P1 and P2 bit-equal to their plain versions, each "
          f"launched once, on {'; '.join(paths)}", flush=True)
    print(f"[8 probe] as the host makes the calls: P1 {p1['call_ms']:.4f} ms, "
          f"torch.gather {gather_call_ms:.4f} ms, P2 {p2['call_ms']:.4f} ms a call", flush=True)
    print(f"[8 probe] queued on the card: P1 {p1['ms'][0]:.4f} ms (plain "
          f"{p1['plain_ms'][0]:.4f} ms, torch.gather {gather_ms:.4f} ms, bound "
          f"{p1['bound'][0][0]:.6f} ms by bytes, launch_floor_ms {floor_ms:.4f}); P2 "
          f"{p2['ms'][0]:.4f} ms for {gp.STEPS} x {PROBE_SHAPE} = {fetches / 1e6:.0f}M "
          f"row-fetches/s (plain {p2['plain_ms'][0]:.1f} ms, bound {p2['bound'][0][1]:.4f} ms "
          f"by shared-memory loads at {SMEM_LOADS_PER_CLOCK}/clock on each of {sms} SMs) "
          f"({card})", flush=True)
    print(f"[8 probe] P2 at ({wide[0]}, {wide[1]}) x {wide[2]}: {wide[3]:.4f} ms on the card, bound "
          f"{wide[4]:.4f} ms by shared-memory loads ({card}); recorded, not measured here: "
          f"the row-staging P1 {PREV_PROBE_MS['take_rows']:.4f} ms and generic-remainder P2 "
          f"{PREV_PROBE_MS['take_loop']:.4f} ms at {PROBE_SHAPE}", flush=True)
    return dict(out, counts=counts, gather_ms=gather_ms, launch_floor_ms=floor_ms)


def bvh_bound_ms(args, work, any_hit: bool) -> tuple:
    """Least time of one B1 or B2 launch on these inputs, as (bytes_ms,
    operations_ms), from the rows each ray visits (bvh12_intersect_plain's
    work on the same inputs).  Bytes: each ray's o, d and t_max in and its
    outputs out (B1 16, B2 1 bytes), and every distinct row visited once.
    Operations: BVH_FLOP per live ray, per child box of each internal row
    visited and per triangle of each leaf row visited."""
    from rs_pbrt_tpu_torch.ops import bvh

    o, _d, t_max = args[:3]
    n = o.shape[0]
    live = int((t_max >= 0).sum())
    nbytes = n * (RAY_BYTES + (1 if any_hit else 16)) + work["rows"] * ROW_BYTES
    flop = (live * BVH_FLOP["ray"] + int(work["internal"].sum()) * bvh.W12 * BVH_FLOP["slab"]
            + int(work["leaf"].sum()) * bvh.W12 * BVH_FLOP["tri"])
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def check_bvh(what, any_hit, got, want) -> float:
    """Fails unless a B1/B2 launch equals its plain version: B2's occlusion
    bits; B1's valid and tri, and t, b0, b1 bit for bit.  Returns the
    largest absolute difference (of t, b0, b1; of the bits for B2)."""
    import torch

    torch.cuda.synchronize()
    if any_hit:
        if not torch.equal(got, want.valid):
            fail(f"{what}: {int((got != want.valid).sum())} occlusion bits differ from the plain "
                 "version")
        return float((got.float() - want.valid.float()).abs().max())
    for k in ("valid", "tri", "t", "b0", "b1"):
        if not torch.equal(getattr(got, k), getattr(want, k)):
            bad = int((getattr(got, k) != getattr(want, k)).sum())
            fail(f"{what}: {k} differs from the plain version on {bad} rays")
    return max(float((getattr(got, k) - getattr(want, k)).abs().max()) for k in ("t", "b0", "b1"))


def phase_statue(card):
    """Phase 9: the statue through build_accel and render.render."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import bvh
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.scene import bigscene
    from rs_pbrt_tpu_torch.tools import bvh_ties

    res, spp, depth = STATUE_RES, STATUE_SPP, DEPTH
    t0 = time.perf_counter()
    scene, camera = bigscene.statue_scene(res, STATUE_SUBDIV, device=DEVICE)
    t1 = time.perf_counter()
    accel = si.build_accel(scene, device=DEVICE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[9 statue] scene {scene.n_tris} triangles in {t1 - t0:.3f} s, BVH "
          f"{accel.tri.shape[0]} wide12 rows, depth {accel.tri_depth}, in {t2 - t1:.3f} s "
          "(host)", flush=True)
    cfg = rdr.RenderCfg("path", spp=spp, max_depth=depth, rr_threshold=1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, spp, res)
    lanes = res[0] * res[1] * spp

    def go(stats=None):
        return rdr.render(scene, camera, cfg, scfg, accel=accel, max_lanes=lanes, stats=stats,
                          regen=False)

    # the main path's run, its wrapper calls recorded with their outputs
    names = ("sobol_dims", "bvh12_intersect_tris")
    rec = {k: LaunchTimer(wrapper(k), keep=True) for k in names}
    overflow = bvh.overflow_counter(DEVICE)
    with ExitStack() as es:
        patched(es, **rec)
        zero_counts()
        overflow.zero_()
        img = go()
        torch.cuda.synchronize()
        counts = read_counts()
    want = expect_counts(sobol=2, bvh12_closest=depth + 1, bvh12_any=depth)
    if counts != want:
        fail(f"launch counts of the statue render {counts}, expected {want}")
    n_overflow = int(overflow.item())
    if n_overflow:
        fail(f"the BVH traversal stack overflowed {n_overflow} times in the statue render")
    if tuple(img.shape) != (res[1], res[0], 3) or not torch.isfinite(img).all():
        fail(f"statue image: shape {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")

    # each launch of that run against its plain version on the same inputs;
    # the plain traversal also counts the rows each ray visits, for the bound
    k1_err, k1_bounds, k1_dev = 0.0, [], []
    for b, (_, args, kw, out) in enumerate(rec["sobol_dims"].calls):
        want_k1 = sk.sobol_dims_plain(*args, **kw)
        torch.cuda.synchronize()
        k1_err = max(k1_err, float((out - want_k1).abs().max()))
        if not torch.equal(out, want_k1):
            fail(f"statue K1 launch {b} differs from its plain version")
        k1_bounds.append(k1_bound_ms(args[0].shape[0], *args[2:4]))
        k1_dev.append(queued_ms(lambda a=args, k=kw: sk.sobol_dims(*a, **k), 20))
    bounds = {"closest": [], "any": []}
    errs = {"closest": 0.0, "any": 0.0}
    work_sum = {"closest": [0, 0], "any": [0, 0]}
    b1_visits, b1_rays = [], []  # per B1 launch: rows visited, rays
    for b, (_, args, kw, out) in enumerate(rec["bvh12_intersect_tris"].calls):
        any_hit = kw.get("any_hit", False)
        key = "any" if any_hit else "closest"
        work = {}
        plain = bvh.bvh12_intersect_plain(*args, any_hit=any_hit, work=work)
        errs[key] = max(errs[key], check_bvh(f"statue B{2 if any_hit else 1} launch {b}",
                                             any_hit, out, plain))
        bounds[key].append(bvh_bound_ms(args, work, any_hit))
        work_sum[key][0] += int(work["internal"].sum())
        work_sum[key][1] += int(work["leaf"].sum())
        if not any_hit:
            b1_visits.append(int(work["internal"].sum()) + int(work["leaf"].sum()))
            b1_rays.append(args[0].shape[0])
    # the inputs of each launch, replayed below for its device time
    replays = [(args, kw) for _, args, kw, _ in rec["bvh12_intersect_tris"].calls]
    del rec, args, kw, out, plain
    # B2 on the first shadow launch cut to B2_TAIL_RAYS rays: the last group
    # fetch holds 5 rays of 16
    shadow = next(a for a, k in replays if k.get("any_hit"))
    cut = tuple(x[:B2_TAIL_RAYS] for x in shadow[:3]) + tuple(shadow[3:])
    errs["any"] = max(errs["any"], check_bvh(
        f"B2 on {B2_TAIL_RAYS} rays", True, bvh.bvh12_intersect_tris(*cut, any_hit=True),
        bvh.bvh12_intersect_plain(*cut, any_hit=True)))
    del shadow, cut
    # the hand-built tree whose walks meet each tie and NaN rule
    o_t, d_t, tm_t, rows_t, depth_t = bvh_ties.tie_case(DEVICE)
    for any_hit in (False, True):
        hit_t = bvh.bvh12_intersect_tris(o_t, d_t, tm_t, rows_t, depth_t, any_hit=any_hit)
        key = "any" if any_hit else "closest"
        errs[key] = max(errs[key], check_bvh(f"B{2 if any_hit else 1} on the tie case", any_hit,
                                             hit_t, bvh.bvh12_intersect_plain(
                                                 o_t, d_t, tm_t, rows_t, depth_t, any_hit)))
    if int(overflow.item()):
        fail("the BVH traversal stack overflowed on the tie case")
    print(f"[9 statue] each launch matches its plain version: B1 valid, tri, t, b0, b1 and B2 "
          f"equal, K1 bit-equal; stack overflows {n_overflow}; rows visited (internal, leaf) "
          f"B1 {work_sum['closest']}, B2 {work_sum['any']}; B1 and B2 equal to the plain "
          f"traversal on the tie case ({o_t.shape[0]} rays), B2 on a shadow launch's first "
          f"{B2_TAIL_RAYS} rays", flush=True)

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
        kinds = ["any" if kw.get("any_hit", False) else "closest"
                 for _, _, kw, _ in timers["bvh12_intersect_tris"].calls]
        runs.append({k: t.times_ms() for k, t in timers.items()})
    ms = {k: [min(col) for col in zip(*(r[k] for r in runs))] for k in names}
    prof = {key: ms_ for ms_, _, key in profile_render(go, "9 profile")}
    # each B1/B2 launch's device time: its recorded inputs replayed, queued
    # behind a sleeping kernel (the events above also time the host's share
    # of a call in this host-bound render)
    dev_ms = [queued_ms(lambda a=a, k=k: bvh.bvh12_intersect_tris(*a, **k), 10)
              for a, k in replays]
    prof_ms = {kind: sum(v for key, v in prof.items() if f"::walk_kernel<{flag}>(" in key)
               for kind, flag in (("closest", "false"), ("any", "true"))}

    # the same render with B1, B2 and K1 swapped for their plain versions
    def plain_bvh(o, d, t_max, rows, depth_, any_hit=False):
        hit = bvh.bvh12_intersect_plain(o, d, t_max, rows, depth_, any_hit)
        return hit.valid if any_hit else hit

    plain_t = dict(sobol_dims=LaunchTimer(sk.sobol_dims_plain),
                   bvh12_intersect_tris=LaunchTimer(plain_bvh))
    with ExitStack() as es:
        patched(es, **plain_t)
        img_plain = go()
    torch.cuda.synchronize()
    err = float((img - img_plain).abs().max())
    if not torch.allclose(img, img_plain, rtol=TOL, atol=TOL):
        fail(f"statue image differs from the plain render by up to {err}")
    plain_ms = {k: t.times_ms() for k, t in plain_t.items()}

    split = lambda xs: {kind: [x for x, k in zip(xs, kinds) if k == kind]
                        for kind in ("closest", "any")}
    b_ms, b_plain = split(ms["bvh12_intersect_tris"]), split(plain_ms["bvh12_intersect_tris"])
    b_dev = split(dev_ms)
    print(f"[9 statue] {scene.n_tris} triangles, {res[0]}x{res[1]}, {spp} spp, depth {depth}, "
          f"one batch of {lanes} paths: finite, matches the plain render (max abs err "
          f"{err:.3g}, mean {float(img.mean()):.5f}); launches {counts}", flush=True)
    print(f"[9 statue] {best['paths_per_s']:.6g} camera paths/s (best of 3 warm renders, "
          f"{1e3 * best['wall_s']:.3f} ms) on {card}", flush=True)
    for kid, key in (("B1", "closest"), ("B2", "any")):
        print(f"[9 statue] {kid} per launch on the card {', '.join(f'{t:.4f}' for t in b_dev[key])} "
              f"ms, as the render's events timed it {', '.join(f'{t:.4f}' for t in b_ms[key])} ms; "
              f"bounds {', '.join(f'{max(b):.4f}' for b in bounds[key])} ms; plain "
              f"{', '.join(f'{t:.1f}' for t in b_plain[key])} ms; profiler, one render "
              f"{prof_ms[key]:.3f} ms", flush=True)
    for b, (t, t_ev, bound, visits, rays) in enumerate(zip(
            b_dev["closest"], b_ms["closest"], bounds["closest"], b1_visits, b1_rays)):
        print(f"[9 B1] launch {b}: {t:.4f} ms on the card, bound {max(bound):.4f} ms; "
              f"{rays / t * 1e3:.6g} rays/s, {visits / t * 1e3:.6g} row visits/s ({visits} rows); "
              f"events {t_ev:.4f} ms ({card}); recorded, not measured here: the "
              f"one-thread-a-ray walk's events {PREV_B1_MS[b]:.3f} ms", flush=True)
    print(f"[9 B1] all launches on the card {sum(b_dev['closest']):.4f} ms, profiler "
          f"{prof_ms['closest']:.4f} ms, events {sum(b_ms['closest']):.4f} ms ({card}); recorded, "
          f"not measured here: the one-thread-a-ray walk's profiler {PREV_B1_DEVICE_MS:.3f} ms, "
          f"events {sum(PREV_B1_MS):.3f} ms", flush=True)
    print(f"[9 B2] all launches on the card {sum(b_dev['any']):.4f} ms "
          f"({', '.join(f'{t:.4f}' for t in b_dev['any'])}), profiler {prof_ms['any']:.4f} ms, "
          f"events {sum(b_ms['any']):.4f} ms ({card}); recorded, not measured here: the "
          f"one-thread-a-ray walk on the card {sum(PREV_B2_DEVICE_MS):.4f} ms "
          f"({', '.join(f'{t:.4f}' for t in PREV_B2_DEVICE_MS)})", flush=True)
    print(f"[9 K1] per launch on the card {', '.join(f'{t:.4f}' for t in k1_dev)} ms, bounds "
          f"{', '.join(f'{max(b):.4f}' for b in k1_bounds)} ms ({card}); recorded, not measured "
          f"here: the one-thread-a-lane kernel "
          f"{', '.join(f'{t:.4f}' for t in PREV_K1_DEVICE_MS['statue'])} ms", flush=True)
    print(f"[9 statue] K1 per launch {', '.join(f'{t:.4f}' for t in ms['sobol_dims'])} ms; "
          f"traversal {sum(ms['bvh12_intersect_tris']):.3f} ms of the "
          f"{1e3 * best['wall_s']:.3f} ms render", flush=True)
    return dict(
        counts=counts, scene=scene, camera=camera, accel=accel,
        sobol_dims=dict(ms=ms["sobol_dims"], device_ms=k1_dev, plain_ms=plain_ms["sobol_dims"],
                        bound=k1_bounds, max_abs_err=k1_err),
        closest=dict(ms=b_ms["closest"], device_ms=b_dev["closest"], plain_ms=b_plain["closest"],
                     bound=bounds["closest"], max_abs_err=errs["closest"]),
        any=dict(ms=b_ms["any"], device_ms=b_dev["any"], plain_ms=b_plain["any"],
                 bound=bounds["any"], max_abs_err=errs["any"]),
    )


def phase_regen_check(card, statue):
    """Phase 10: regen.radiance_regen at REGEN_CHECK_WIDTH lanes on phase
    9's statue and camera paths, against general_radiance."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod
    from rs_pbrt_tpu_torch.models.integrators import regen
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import bvh

    scene, camera, accel = statue["scene"], statue["camera"], statue["accel"]
    scfg = smpl.make_sampler(smpl.SOBOL, STATUE_SPP, STATUE_RES)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, STATUE_SPP)
    pcfg = pathmod.PathCfg(DEPTH, 1.0)
    n = rays.o.shape[0]
    rec = LaunchTimer(bvh.bvh12_intersect_tris, keep=True)
    overflow = bvh.overflow_counter(DEVICE)
    st = {}
    torch.cuda.synchronize()
    with ExitStack() as es:
        patched(es, bvh12_intersect_tris=rec)
        zero_counts()
        overflow.zero_()
        t0 = time.perf_counter()
        L = regen.radiance_regen(scene, pcfg, scfg, ctx, rays.o, rays.d, accel,
                                 lane_width=REGEN_CHECK_WIDTH, stats=st)
        torch.cuda.synchronize()
        regen_s = time.perf_counter() - t0
        counts = read_counts()
    n_it = st["iterations"]
    want = expect_counts(sobol=1, bvh12_closest=n_it, bvh12_any=n_it)
    if counts != want:
        fail(f"launch counts of the regeneration check {counts}, expected {want}")
    if int(overflow.item()):
        fail(f"the BVH traversal stack overflowed {int(overflow.item())} times in the "
             "regeneration check")
    closest = [c for c in rec.calls if not c[2].get("any_hit", False)]
    shadow = [c for c in rec.calls if c[2].get("any_hit", False)]
    live = [int((args[2] >= 0).sum()) for _, args, _, _ in closest]
    last = max(i for i, v in enumerate(live) if v > 0)
    picks = sorted({0, n_it // 2, last})
    err = 0.0
    for i in picks:
        for any_hit, (_, args, kw, out) in ((False, closest[i]), (True, shadow[i])):
            err = max(err, check_bvh(f"regeneration iteration {i} B{2 if any_hit else 1}",
                                     any_hit, out, bvh.bvh12_intersect_plain(*args, **kw)))
    del rec, closest, shadow, args, kw, out
    t0 = time.perf_counter()
    L_fixed = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, accel)
    torch.cuda.synchronize()
    fixed_s = time.perf_counter() - t0
    if not torch.isfinite(L).all():
        fail("the regeneration check's radiance is not finite")
    path_err = float((L - L_fixed).abs().max())
    if not torch.allclose(L, L_fixed, rtol=1e-5, atol=1e-6):
        fail(f"the regeneration loop's radiance differs from general_radiance by up to {path_err}")
    print(f"[10 regen] {n} paths through {REGEN_CHECK_WIDTH} lanes: {n_it} iterations, "
          f"{sum(live)} live lanes of {n_it * REGEN_CHECK_WIDTH} "
          f"({100 * sum(live) / (n_it * REGEN_CHECK_WIDTH):.1f}%); launches {counts}; stack "
          f"overflows 0; B1 and B2 of iterations {picks} (live rays "
          f"{[live[i] for i in picks]}) equal to the plain traversal (max abs err {err:.3g}); "
          f"radiance matches general_radiance at rtol 1e-5, atol 1e-6 (max abs err "
          f"{path_err:.3g}, {int(torch.equal(L, L_fixed))} bit-equal)", flush=True)
    print(f"[10 regen] host clock: the loop {regen_s:.3f} s ({n / regen_s:.6g} paths/s, "
          f"{1e3 * regen_s / n_it:.3f} ms an iteration), the fixed-depth loop {fixed_s:.3f} s "
          f"({n / fixed_s:.6g} paths/s) ({card})", flush=True)
    return dict(counts=counts, max_abs_err=err)


def phase_spatial_crop(card):
    """Phase 11: a spatial-selection render and a crop-window render, each
    against the render with every wrapper swapped for its plain version."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.scene import presets

    scfg = smpl.make_sampler(smpl.SOBOL, SPP, RES)
    lanes = RES[0] * RES[1] * SPP
    out = {}
    for name, (scene, camera), cfg, launched in (
            ("spatial", presets.spheres_direct(RES, device=DEVICE),
             dict(light_strategy="spatial"),
             dict(sobol=2, full_sweep=DEPTH + 1, any_sweep=DEPTH)),
            ("crop", presets.cornell_box(RES, device=DEVICE), dict(crop=CROP),
             dict(sobol=1, bounce=DEPTH + 1))):
        cfg = rdr.RenderCfg("path", SPP, DEPTH, 1.0, **cfg)

        def go(stats=None):
            return rdr.render(scene, camera, cfg, scfg, max_lanes=lanes, stats=stats)

        if name == "spatial":
            from rs_pbrt_tpu_torch.models import lightdistrib as ldist

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sd = ldist.build_spatial(scene)
            torch.cuda.synchronize()
            print(f"[11 spatial] the spatial light distribution: {sd.n_voxels} voxels x "
                  f"{scene.n_lights} lights x {ldist.N_SAMPLES} samples, built in "
                  f"{1e3 * (time.perf_counter() - t0):.3f} ms (host clock) on {card}", flush=True)
            del sd
        go()  # warm
        st = {}
        torch.cuda.synchronize()
        zero_counts()
        img = go(st)
        counts = read_counts()
        if counts != expect_counts(**launched):
            fail(f"launch counts of the {name} render {counts}, expected {launched}")
        if tuple(img.shape) != (RES[1], RES[0], 3) or not torch.isfinite(img).all():
            fail(f"{name} image: shape {tuple(img.shape)}, finite "
                 f"{bool(torch.isfinite(img).all())}")
        with ExitStack() as es:
            patched(es, sobol_dims=sk.sobol_dims_plain, bounce=pk.bounce_plain,
                    closest_sweep=ik.closest_sweep_plain, any_sweep=ik.any_sweep_plain,
                    full_sweep=ik.full_sweep_plain)
            img_plain = go()
        torch.cuda.synchronize()
        err = float((img - img_plain).abs().max())
        if not torch.allclose(img, img_plain, rtol=TOL, atol=TOL):
            fail(f"{name} image differs from the plain render by up to {err}")
        note = ""
        if name == "crop":
            px0, px1, py0, py1 = rdr.crop_pixel_rect(RES, CROP)
            inside = torch.zeros(img.shape[:2], dtype=torch.bool, device=img.device)
            inside[py0:py1, px0:px1] = True
            if bool((img[~inside] != 0).any()) or not bool((img[inside] > 0).any()):
                fail("the crop render lights pixels outside its window, or none inside")
            note = f", pixels x {px0}..{px1 - 1}, y {py0}..{py1 - 1}, black outside"
        print(f"[11 {name}] {RES[0]}x{RES[1]}, {SPP} spp, depth {DEPTH}{note}: finite, matches "
              f"the plain render (max abs err {err:.3g}, mean {float(img.mean()):.5f}); launches "
              f"{counts}; {st['paths_per_s']:.6g} camera paths/s (one warm render, "
              f"{1e3 * st['wall_s']:.3f} ms) on {card}", flush=True)
        out[name] = dict(counts=counts)
    return out


def phase_full_statue(card):
    """Phase 12: the 5.24M-triangle statue at 1024x1024, 64 spp, through
    render's defaults (regeneration)."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import bvh
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.scene import bigscene

    t0 = time.perf_counter()
    scene, camera = bigscene.statue_scene(FULL_RES, FULL_SUBDIV, device=DEVICE)
    t1 = time.perf_counter()
    accel = si.build_accel(scene, device=DEVICE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[12 statue] scene {scene.n_tris} triangles in {t1 - t0:.3f} s, BVH "
          f"{accel.tri.shape[0]} wide12 rows, depth {accel.tri_depth}, in {t2 - t1:.3f} s "
          "(host)", flush=True)
    cfg = rdr.RenderCfg("path", spp=FULL_SPP, max_depth=DEPTH, rr_threshold=1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, FULL_SPP, FULL_RES)
    paths = FULL_RES[0] * FULL_RES[1] * FULL_SPP
    warm = {}
    rdr.render(scene, camera, cfg._replace(spp=1), scfg, accel=accel, stats=warm)
    overflow = bvh.overflow_counter(DEVICE)
    overflow.zero_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the scene, its tree and the caches
    st = {}
    zero_counts()
    img = rdr.render(scene, camera, cfg, scfg, accel=accel, stats=st)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if not st["lane_width"]:
        fail("the full-width statue render did not take the regeneration loop")
    want = expect_counts(sobol=2 * st["batches"], bvh12_closest=st["iterations"],
                         bvh12_any=st["iterations"])
    if counts != want:
        fail(f"launch counts of the full-width statue render {counts}, expected {want}")
    n_overflow = int(overflow.item())
    if n_overflow:
        fail(f"the BVH traversal stack overflowed {n_overflow} times in the full-width render")
    if tuple(img.shape) != (FULL_RES[1], FULL_RES[0], 3) or not torch.isfinite(img).all():
        fail(f"full-width statue image: shape {tuple(img.shape)}, finite "
             f"{bool(torch.isfinite(img).all())}")
    print(f"[12 statue] {FULL_RES[0]}x{FULL_RES[1]}, {FULL_SPP} spp, depth {DEPTH}, {paths} "
          f"paths: {st['batches']} batches of up to {rdr.MAX_LANES} paths through "
          f"{st['lane_width']} lanes, {st['iterations']} iterations; launches {counts}; stack "
          f"overflows 0; peak device memory {peak / 2**30:.2f} GiB, "
          f"{(peak - held) / min(paths, rdr.MAX_LANES):.1f} bytes a path of a batch "
          "above what the scene and its tree hold", flush=True)
    print(f"[12 statue] {st['paths_per_s']:.6g} camera paths/s (one timed render, "
          f"{st['wall_s']:.3f} s, after a warm render of 1 spp in {warm['wall_s']:.3f} s) on "
          f"{card}", flush=True)
    fixed = {}
    torch.cuda.reset_peak_memory_stats()
    img_fixed = rdr.render(scene, camera, cfg, scfg, accel=accel, stats=fixed, regen=False)
    peak_fixed = torch.cuda.max_memory_allocated()
    err = float((img - img_fixed).abs().max())
    if not torch.allclose(img, img_fixed, rtol=1e-5, atol=1e-6):
        fail(f"the full-width regeneration render differs from regen=False by up to {err}")
    print(f"[12 statue] finite, matches the regen=False render in {fixed['batches']} batches "
          f"at rtol 1e-5, atol 1e-6 (max abs err {err:.3g}, "
          f"{int(torch.equal(img, img_fixed))} "
          f"bit-equal, mean {float(img.mean()):.5f}); the fixed-depth loop "
          f"{fixed['paths_per_s']:.6g} camera paths/s ({fixed['wall_s']:.3f} s), peak device "
          f"memory {peak_fixed / 2**30:.2f} GiB, "
          f"{(peak_fixed - held) / min(paths, rdr.MAX_LANES):.1f} bytes a path, on {card}",
          flush=True)
    del img_fixed
    batch = cfg._replace(spp=FULL_SPP // st["batches"])
    # the profiled batch also keeps the rays of its middle iteration's B1 and
    # B2 launches, for their bounds
    kept, seen = {}, {"closest": 0, "any": 0}
    middle = st["iterations"] // (2 * st["batches"])
    traverse = bvh.bvh12_intersect_tris

    def keep_middle(o, d, t_max, rows, depth_, any_hit=False):
        key = "any" if any_hit else "closest"
        if seen[key] == middle:
            kept[key] = (o.clone(), d.clone(), t_max.clone(), rows, depth_)
        seen[key] += 1
        return traverse(o, d, t_max, rows, depth_, any_hit=any_hit)

    with ExitStack() as es:
        patched(es, bvh12_intersect_tris=keep_middle)
        prof = profile_render(lambda: rdr.render(scene, camera, batch, scfg, accel=accel),
                              f"12 profile, one batch of {batch.spp} spp")
    prof_ms = {kind: sum(v for v, _, key in prof if f"::walk_kernel<{flag}>(" in key)
               for kind, flag in (("closest", "false"), ("any", "true"))}
    for kind, (o, d, t_max, rows, depth_) in kept.items():
        n = o.shape[0]
        bms, fms = sampled_bvh_bound_ms(o, d, t_max, rows, depth_, kind == "any")
        print(f"[12 {'B2' if kind == 'any' else 'B1'}] the profiled batch's launch {middle} of "
              f"{seen[kind]}, {n} rays: bound {max(bms, fms):.4f} ms (bytes {bms:.4f}, "
              f"operations {fms:.4f}; counted on one ray in {n // BOUND_SAMPLE_RAYS} and "
              f"scaled to the launch), against {prof_ms[kind] / seen[kind]:.4f} ms a launch on "
              f"the card (profiler) ({card})", flush=True)
    return dict(counts=counts)


def sampled_bvh_bound_ms(o, d, t_max, rows, depth, any_hit) -> tuple:
    """bvh_bound_ms of a launch of n rays counted on a sample of
    BOUND_SAMPLE_RAYS of them (every n/BOUND_SAMPLE_RAYS-th ray): the
    operations and each ray's bytes scaled by n over the sample, the
    distinct rows the sample visits kept as they are (the launch visits at
    least those), so the sum stays a bound."""
    from rs_pbrt_tpu_torch.ops import bvh

    n = o.shape[0]
    step = max(1, n // BOUND_SAMPLE_RAYS)
    sample = (o[::step].contiguous(), d[::step].contiguous(), t_max[::step].contiguous())
    work = {}
    bvh.bvh12_intersect_plain(*sample, rows, depth, any_hit, work=work)
    m = sample[0].shape[0]
    live = int((t_max >= 0).sum())
    nbytes = n * (RAY_BYTES + (1 if any_hit else 16)) + work["rows"] * ROW_BYTES
    flop = (live * BVH_FLOP["ray"] + (n / m) * (int(work["internal"].sum()) * bvh.W12
                                                  * BVH_FLOP["slab"]
                                                  + int(work["leaf"].sum()) * bvh.W12
                                                  * BVH_FLOP["tri"]))
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def curve_bound_ms(args, any_hit: bool, work: dict, walk: bool) -> tuple:
    """Least time of one C1-C4 launch on these inputs, as (bytes_ms,
    operations_ms), from the plain versions' work on the same inputs.
    Bytes: each ray's o, d and t_max in and its outputs out; C1/C2 every
    distinct node and segment row read once, C3/C4 the table once.
    Operations: CURVE_FLOP per ray (the walk's live rays, with 1/d), per
    child box tested (two a node visited) and per leaf test (the sweeps'
    every pair, the any hits' up to each ray's first hit)."""
    o, t_max = args[0], args[2]
    n = o.shape[0]
    f = CURVE_FLOP
    out = 1 if any_hit else CURVE_OUT_BYTES
    if walk:
        live = int((t_max >= 0).sum())
        nbytes = (n * (RAY_BYTES + out) + work["node_rows"] * CURVE_NODE_BYTES
                  + work["seg_rows"] * CURVE_ROW_BYTES)
        flop = (live * (f["ray"] + f["inv_d"]) + int(work["nodes"].sum()) * 2 * f["slab"]
                + int(work["tests"].sum()) * f["test"])
    else:
        rows = args[3]
        nbytes = n * (RAY_BYTES + out) + rows.shape[0] * CURVE_ROW_BYTES
        flop = n * f["ray"] + work["tests"] * f["test"]
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def check_curves(what: str, got, want) -> tuple:
    """Fails unless a C1-C4 launch matches its plain version: the any hits
    equal; valid and seg equal, t, u, v, w bit-equal (NaN matching NaN) or,
    where not, within rtol = atol = TOL.  Returns (largest absolute
    difference, whether t, u, v, w were bit-equal)."""
    import torch

    torch.cuda.synchronize()
    if torch.is_tensor(got):
        if not torch.equal(got, want):
            fail(f"{what}: {int((got != want).sum())} any-hit bits differ from the plain version")
        return 0.0, True
    for k in ("valid", "seg"):
        if not torch.equal(getattr(got, k), getattr(want, k)):
            bad = int((getattr(got, k) != getattr(want, k)).sum())
            fail(f"{what}: {k} differs from the plain version on {bad} rays")
    err, exact = 0.0, True
    for k in ("t", "u", "v", "w"):
        a, b = getattr(got, k), getattr(want, k)
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        if bool(same.all()):
            continue
        exact = False
        if not torch.allclose(a, b, rtol=TOL, atol=TOL, equal_nan=True):
            fail(f"{what}: {k} differs from the plain version by up to "
                 f"{float((a - b).abs().nan_to_num().max())}")
        err = max(err, float((a - b)[~same].abs().nan_to_num().max()))
    return err, exact


def timed_ms(fn):
    """(fn()'s result, its time on the card by CUDA events around one call)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_curves(card):
    """Phase 13: C1-C4 against their plain versions on the card."""
    import numpy as np
    import torch

    from rs_pbrt_tpu_torch.ops import curve_kernel as ck
    from rs_pbrt_tpu_torch.ops import curves as cv
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.tools import curve_cases, hair_scenes

    t0 = time.perf_counter()
    fur, _ = hair_scenes.fur_patch(FUR_FIBERS, device=DEVICE)
    t1 = time.perf_counter()
    accel = si.build_accel(fur, device=DEVICE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[13 curves] fur patch: {FUR_FIBERS} fibres, {fur.n_curve_segs} segments in "
          f"{t1 - t0:.3f} s, their binary tree ({accel.crv.child.shape[0]} nodes) in "
          f"{t2 - t1:.3f} s (host)", flush=True)
    patch, _ = hair_scenes.hair_patch(device=DEVICE)
    table = curve_cases.table_rows(CURVE_TABLE_ROWS)
    deep, _, n_deep = curve_cases.clamp_tree(table, device=DEVICE)
    table_t = torch.as_tensor(table, device=DEVICE)
    fur_rays = curve_cases.fur_rays(CURVE_RAYS, device=DEVICE)
    table_rays = curve_cases.rays_at(table, CURVE_RAYS, device=DEVICE)[:3]
    clamp = ck.clamp_counter(DEVICE)
    cases = (
        ("fur tree", True, fur_rays, (accel.crv, fur.crv_attr)),
        ("stack-clamp tree", True, table_rays, (deep, table_t[:n_deep])),
        ("hair_patch rows", False, fur_rays, (patch.crv_attr,)),
        (f"{CURVE_TABLE_ROWS} rows", False, table_rays, (table_t,)),
    )
    out = {k: dict(max_abs_err=0.0, exact=True, cases=[]) for k in
           ("walk_closest", "walk_any", "sweep_closest", "sweep_any")}
    for what, walk, rays, extra in cases:
        for any_hit in (False, True):
            name = ("walk_" if walk else "sweep_") + ("any" if any_hit else "closest")
            kernel = getattr(ck, name)
            args = (*rays, *extra)
            work = {}
            if walk:
                plain_fn = lambda: cv.bvh_intersect_curves_plain(*args, any_hit=any_hit, work=work)
            else:
                plain_fn = lambda: cv.intersect_curves_plain(*rays, extra[0], any_hit=any_hit,
                                                             work=work)
            clamp.zero_()
            got = kernel(*args)
            torch.cuda.synchronize()
            n_clamped = int(clamp.item())
            want, plain_ms = timed_ms(plain_fn)
            err, exact = check_curves(f"{name} on the {what}", got, want)
            if walk and n_clamped != work["clamped"]:
                fail(f"{name} on the {what}: the kernel's stack clamped {n_clamped} pushes, the "
                     f"plain walk {work['clamped']}")
            dev_ms = queued_ms(lambda: kernel(*args), 5)
            ev_ms = cuda_ms(lambda: kernel(*args), 5)
            bound = curve_bound_ms((*rays, *extra[-1:]), any_hit, work, walk)
            hits = int((got if any_hit else got.valid).sum())
            o = out[name]
            o["max_abs_err"] = max(o["max_abs_err"], err)
            o["exact"] &= exact
            o["cases"].append(dict(what=what, device_ms=dev_ms, ms=ev_ms, plain_ms=plain_ms,
                                   bound=bound))
            detail = ("bit-equal t, u, v, w" if exact or any_hit
                      else f"t, u, v, w within {TOL} (max abs err {err:.3g}), not bit-equal")
            tests = int(work["tests"].sum()) if walk else work["tests"]
            print(f"[13 {name}] {what}, {rays[0].shape[0]} rays: {hits} hits, equal to the plain "
                  f"version ({'any hit' if any_hit else 'valid, seg'}; {detail})"
                  + (f", stack clamps {n_clamped} = plain" if walk else "")
                  + f"; {tests} leaf tests; on the card {dev_ms:.4f} ms, events {ev_ms:.4f} ms, "
                  f"plain {plain_ms:.1f} ms, bound {max(bound):.4f} ms (bytes {bound[0]:.4f}, "
                  f"operations {bound[1]:.4f}) ({card})", flush=True)
            del got, want
    return out


def phase_hair_renders(card):
    """Phase 14: hair_patch and the fur patch through render.render."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import regen
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import curve_kernel as ck
    from rs_pbrt_tpu_torch.ops import curves as cv
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.tools import hair_scenes

    cfg = hair_scenes.CFG
    res = hair_scenes.RESOLUTION
    scfg = smpl.make_sampler(smpl.SOBOL, cfg.spp, res)
    paths = res[0] * res[1] * cfg.spp
    depth = cfg.max_depth
    results = {}
    for name in ("hair_patch", "fur_patch"):
        t0 = time.perf_counter()
        if name == "hair_patch":
            scene, camera = hair_scenes.hair_patch(res, device=DEVICE)
        else:
            scene, camera = hair_scenes.fur_patch(FUR_FIBERS, resolution=res, device=DEVICE)
        t1 = time.perf_counter()
        accel = si.build_accel(scene, device=DEVICE)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        walk = accel.crv is not None
        width = FUR_LANE_WIDTH if walk else regen.REGEN_LANE_WIDTH

        def go(stats=None):
            old = regen.REGEN_LANE_WIDTH
            regen.REGEN_LANE_WIDTH = width
            try:
                return rdr.render(scene, camera, cfg, scfg, accel=accel, stats=stats)
            finally:
                regen.REGEN_LANE_WIDTH = old

        print(f"[14 {name}] {scene.n_curve_segs} curve segments, {scene.n_tris} triangles, "
              f"{scene.n_lights} point lights: scene {t1 - t0:.3f} s, "
              + (f"curve tree {t2 - t1:.3f} s (host)" if walk else "no tree (the dense sweeps)"),
              flush=True)
        go()  # warm
        names = ("walk_closest", "walk_any") if walk else ("sweep_closest", "sweep_any")
        rec = {k: LaunchTimer(wrapper(k), keep=True) for k in
               names + ("sobol_dims", "full_sweep", "any_sweep")}
        clamp = ck.clamp_counter(DEVICE)
        st = {}
        with ExitStack() as es:
            patched(es, **rec)
            clamp.zero_()
            torch.cuda.synchronize()
            zero_counts()
            img = go(st)
            torch.cuda.synchronize()
            counts = read_counts()
        it = st["iterations"]
        if walk:
            if not st["lane_width"]:
                fail(f"the {name} render did not take the regeneration loop")
            want_counts = expect_counts(sobol=2 * st["batches"], full_sweep=it, any_sweep=it,
                                        curve_walk_closest=it, curve_walk_any=it)
        else:
            want_counts = expect_counts(sobol=2, full_sweep=depth + 1, any_sweep=depth,
                                        curve_sweep_closest=depth + 1, curve_sweep_any=depth)
        if counts != want_counts:
            fail(f"launch counts of the {name} render {counts}, expected {want_counts}")
        if int(clamp.item()):
            fail(f"the curve walk's stack clamped {int(clamp.item())} pushes in the {name} render")
        if tuple(img.shape) != (res[1], res[0], 3) or not torch.isfinite(img).all():
            fail(f"{name} image: shape {tuple(img.shape)}, finite "
                 f"{bool(torch.isfinite(img).all())}")
        # hair_patch: every launch of that run against its plain version
        checked = ""
        if not walk:
            k1 = [torch.equal(out, sk.sobol_dims_plain(*a, **kw))
                  for _, a, kw, out in rec["sobol_dims"].calls]
            if not all(k1):
                fail(f"a K1 launch of the {name} render differs from its plain version")
            for kind, plain in (("full", ik.full_sweep_plain), ("any", ik.any_sweep_plain)):
                for b, (_, a, kw, out) in enumerate(rec[f"{kind}_sweep"].calls):
                    check_isect(f"{name} K{5 if kind == 'full' else 4} launch {b}", kind, out,
                                plain(*a, **kw))
            checked = "; every K1, K4, K5, C3 and C4 launch equal to its plain version"
        entry = {}
        for k in names:
            any_hit = k.endswith("any")
            plain_fn = (cv.bvh_intersect_curves_plain if walk else cv.intersect_curves_plain)
            bounds, errs, exact = [], 0.0, True
            checks = (range(len(rec[k].calls)) if not walk else sorted(
                {0, len(rec[k].calls) // 2, len(rec[k].calls) - 1}))
            for b in checks:
                _, a, kw, out = rec[k].calls[b]
                work = {}
                want = plain_fn(*a, any_hit=any_hit, work=work)
                err, ex = check_curves(f"{name} {k} launch {b}", out, want)
                errs, exact = max(errs, err), exact and ex
                bounds.append(curve_bound_ms(a, any_hit, work, walk))
            replays = [(a, kw) for _, a, kw, _ in rec[k].calls]
            dev_ms = [queued_ms(lambda a=a, kw=kw: wrapper(k)(*a, **kw), 3) for a, kw in replays]
            entry[k] = dict(ms=rec[k].times_ms(), device_ms=dev_ms, bound=bounds,
                            max_abs_err=errs, exact=exact, checked=list(checks))
        if walk:
            checked = (f"; C1 and C2 of the first, middle and last iteration "
                       f"({entry['walk_closest']['checked']}) equal to their plain versions")
        del rec

        # the same render with every wrapper swapped for its plain version;
        # the curve kernels' plain times are its launches'
        plain_t = {k: LaunchTimer(getattr(cv, "bvh_intersect_curves_plain" if walk else
                                          "intersect_curves_plain")) for k in names}

        def plain_curve(k):
            timer = plain_t[k]
            any_hit = k.endswith("any")
            return lambda *a: timer(*a, any_hit=any_hit)

        with ExitStack() as es:
            patched(es, sobol_dims=sk.sobol_dims_plain, full_sweep=ik.full_sweep_plain,
                    any_sweep=ik.any_sweep_plain, **{k: plain_curve(k) for k in names})
            img_plain = go()
        torch.cuda.synchronize()
        diff = (img - img_plain).abs()
        err = float(diff.max())
        off = float((diff > TOL + TOL * img_plain.abs()).any(-1).float().mean())
        if not torch.allclose(img, img_plain, rtol=TOL, atol=TOL):
            fail(f"{name} image differs from the plain render by up to {err} ({100 * off:.3f}% "
                 "of the pixels)")
        for k in names:
            entry[k]["plain_ms"] = plain_t[k].times_ms()
        best = None
        for _ in range(3):
            s_ = {}
            go(s_)
            best = s_ if best is None or s_["wall_s"] < best["wall_s"] else best
        prof = profile_render(go, f"14 {name} profile")
        busy = sum(r[0] for r in prof)
        print(f"[14 {name}] {res[0]}x{res[1]}, {cfg.spp} spp, depth {depth}, {paths} paths"
              + (f" through {width} lanes, {it} iterations" if walk else ", the fixed-depth loop")
              + f": finite, matches the plain render (max abs err {err:.3g}, {100 * off:.3f}% of "
              f"the pixels off by more than {TOL}, mean {float(img.mean()):.5f}); launches "
              f"{counts}; stack clamps 0{checked}", flush=True)
        print(f"[14 {name}] {best['paths_per_s']:.6g} camera paths/s (best of 3 warm renders, "
              f"{1e3 * best['wall_s']:.3f} ms) on {card}; the profiled render's device busy "
              f"{busy:.3f} ms", flush=True)
        for k in names:
            e = entry[k]
            print(f"[14 {name}] {k} per launch on the card "
                  f"{', '.join(f'{t:.4f}' for t in e['device_ms'])} ms, events "
                  f"{', '.join(f'{t:.4f}' for t in e['ms'])} ms, plain "
                  f"{', '.join(f'{t:.1f}' for t in e['plain_ms'])} ms; bounds of launches "
                  f"{e['checked']} {', '.join(f'{max(b):.4f}' for b in e['bound'])} ms; "
                  + ("t, u, v, w bit-equal" if e["exact"] else
                     f"t, u, v, w within {TOL} (max abs err {e['max_abs_err']:.3g})"), flush=True)
        results[name] = dict(counts=counts, **entry)
        del scene, camera, accel, img, img_plain
    return results


def phase_glass(card):
    """Phase 15: the caustic scene's geometry (a smooth glass sphere over a
    matte floor) with path, whitted and directlighting through
    render.render, each launch and image against their plain versions."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.tools import caustic_scenes

    scene, camera = caustic_scenes.caustic_only(GLASS_RES, device=DEVICE)
    depth = caustic_scenes.CFG.max_depth
    out = {}
    for integrator, spp in GLASS_RUNS:
        tag = f"15 {integrator}"
        # the file's light selection for path (spatial); one light by power
        # for directlighting, where "all" would repeat whitted
        one = integrator == "directlighting"
        cfg = rdr.RenderCfg(integrator, spp, depth, 1.0, light_strategy="spatial",
                            extra={"strategy": "one"} if one else None)
        scfg = smpl.make_sampler(smpl.SOBOL, spp, GLASS_RES)

        def go(stats=None):
            return rdr.render(scene, camera, cfg, scfg, stats=stats)

        if integrator == "path":
            launched = dict(sobol=2, full_sweep=depth + 1, any_sweep=depth)
        else:
            launched = dict(sobol=1 + depth, full_sweep=depth,
                            any_sweep=depth * (1 if one else scene.n_lights))
        go()  # warm
        rec = {k: LaunchTimer(wrapper(k), keep=True) for k in SWEEP_NAMES}
        st = {}
        with ExitStack() as es:
            patched(es, **rec)
            torch.cuda.synchronize()
            zero_counts()
            img = go(st)
            torch.cuda.synchronize()
            counts = read_counts()
        if counts != expect_counts(**launched):
            fail(f"launch counts of the glass {integrator} render {counts}, expected {launched}")
        if tuple(img.shape) != (GLASS_RES[1], GLASS_RES[0], 3) or not torch.isfinite(img).all():
            fail(f"glass {integrator} image: shape {tuple(img.shape)}, finite "
                 f"{bool(torch.isfinite(img).all())}")
        part = check_sweep_launches(f"glass {integrator}", rec)
        del rec
        plain_t = {k: LaunchTimer(v) for k, v in plain_fns().items() if k in SWEEP_NAMES}
        with ExitStack() as es:
            patched(es, **plain_t)
            img_plain = go()
        torch.cuda.synchronize()
        err = compare_plain(f"glass {integrator} image", img, img_plain)
        for k in SWEEP_NAMES:
            part[k]["plain_ms"] = plain_t[k].times_ms()
        print(f"[{tag}] caustic_only's geometry {GLASS_RES[0]}x{GLASS_RES[1]}, {spp} spp, depth "
              f"{depth}: finite, matches the plain render (max abs err {err:.3g}, mean "
              f"{float(img.mean()):.5f}); launches {counts}; every K1 launch bit-equal, K4 equal, "
              f"K5 within {TOL}; {st['paths_per_s']:.6g} camera paths/s (one warm render, "
              f"{1e3 * st['wall_s']:.3f} ms) on {card}", flush=True)
        for k, kid in (("sobol_dims", "K1"), ("full_sweep", "K5"), ("any_sweep", "K4")):
            p = part[k]
            print(f"[{tag}] {kid} per launch {sum(p['ms']) / len(p['ms']):.4f} ms (events, mean "
                  f"of {len(p['ms'])}), bound {sum(max(b) for b in p['bound']) / len(p['bound']):.4f}"
                  f" ms, plain {sum(p['plain_ms']) / len(p['plain_ms']):.3f} ms", flush=True)
        out[integrator] = dict(part, counts=counts)
    return out


def s1_bound_ms(args, work) -> tuple:
    """Least time of one S1 launch on these inputs, as (bytes_ms,
    operations_ms), from the plain deposit's work on the same inputs.
    Bytes: the event rows once, each VP's inputs and outputs (S1_VP_BYTES).
    Operations: S1_FLOP per tested pair, per near pair and per near pair's
    lobe."""
    rows, n_vp = args[0], args[4].shape[0]
    f = S1_FLOP
    nbytes = rows.shape[0] * S1_ROW_BYTES + n_vp * S1_VP_BYTES
    flop = (work["tested"] * f["test"] + work["near"] * f["near"]
            + work["lambert_near"] * f["lambert"] + work["oren_nayar_near"] * f["oren_nayar"]
            + work["hair_near"] * f["hair"])
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def check_deposit(what: str, args, got, want) -> tuple:
    """Fails unless an S1 launch matches the plain deposit: m bit-equal,
    phi bit-equal on the VPs of Lambert and Oren-Nayar lobes and on those
    of the hair lobe bit-equal or, where not, within rtol 1e-5, atol 1e-7
    (the hair lobe's exp, log and atan2 on the card).  Returns (largest
    absolute difference, whether phi was bit-equal, hair VPs off)."""
    import torch

    from rs_pbrt_tpu_torch.ops import bsdf as bx

    torch.cuda.synchronize()
    phi, m = got
    want_phi, want_m = want
    if not torch.equal(m, want_m):
        fail(f"{what}: m differs from the plain deposit on {int((m != want_m).sum())} VPs")
    same = (phi == want_phi).all(-1)
    if bool(same.all()):
        return 0.0, True, 0
    hair = args[10].kind0 == bx.LOBE_HAIR
    if bool((~same & ~hair).any()):
        fail(f"{what}: phi differs from the plain deposit on {int((~same & ~hair).sum())} VPs "
             "of a Lambert or Oren-Nayar lobe")
    if not torch.allclose(phi[hair], want_phi[hair], rtol=1e-5, atol=1e-7):
        fail(f"{what}: phi on hair VPs differs from the plain deposit by up to "
             f"{float((phi - want_phi).abs().max())}")
    return float((phi - want_phi).abs().max()), False, int((~same).sum())


def phase_sppm(card):
    """Phase 16: caustic_only and caustic_hair through render.render with
    SPPM at their own settings, every S1 launch against the plain deposit,
    and one iteration's deposit of 2^20 photons on 1024x1024 VPs."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.models.integrators import sppm
    from rs_pbrt_tpu_torch.ops import curves as cv
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.ops import sppm_kernel as sd
    from rs_pbrt_tpu_torch.tools import caustic_scenes

    cfg = caustic_scenes.CFG
    n_it, depth = cfg.extra["n_iterations"], cfg.max_depth
    scfg = smpl.make_sampler(smpl.RANDOM, cfg.spp, SPPM_RES)
    w, h = SPPM_RES
    out = {}
    for name in ("caustic_only", "caustic_hair"):
        tag = f"16 {name}"
        scene, camera = getattr(caustic_scenes, name)(SPPM_RES, device=DEVICE)
        accel = si.build_accel(scene, device=DEVICE)

        def go(stats=None, iterations=n_it):
            c = cfg._replace(extra=dict(cfg.extra, n_iterations=iterations))
            return rdr.render(scene, camera, c, scfg, accel=accel, stats=stats)

        go(iterations=SPPM_WARM_ITERATIONS)
        rec = LaunchTimer(wrapper("deposit"), keep=True)
        st = {}
        with ExitStack() as es:
            patched(es, deposit=rec)
            torch.cuda.synchronize()
            zero_counts()
            img = go(st)
            torch.cuda.synchronize()
            counts = read_counts()
        curves = dict(curve_sweep_closest=2 * depth * n_it, curve_sweep_any=depth * n_it)
        launched = dict(sppm_deposit=n_it, full_sweep=2 * depth * n_it, any_sweep=depth * n_it,
                        **(curves if scene.n_curve_segs else {}))
        if counts != expect_counts(**launched):
            fail(f"launch counts of the {name} render {counts}, expected {launched}")
        if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
            fail(f"{name} image: shape {tuple(img.shape)}, finite "
                 f"{bool(torch.isfinite(img).all())}")
        rays_per_s = w * h * n_it * 2 / st["wall_s"]
        part = dict(ms=rec.times_ms(), device_ms=[], bound=[], max_abs_err=0.0, exact=True,
                    hair_off=0)
        for b, (_, a, kw, o) in enumerate(rec.calls):
            work = {}
            err, exact, off = check_deposit(f"{name} S1 launch {b}", a, o,
                                            sd.deposit_plain(*a, work=work))
            part["max_abs_err"] = max(part["max_abs_err"], err)
            part["exact"] &= exact
            part["hair_off"] += off
            part["bound"].append(s1_bound_ms(a, work))
            packed = (*a[:4], *sd.pack_vps(*a[4:11]), a[11])
            part["device_ms"].append(queued_ms(lambda p=packed: sd.launch(*p), 3))
            if b == 0:
                part["work0"] = work
        del rec, a, o
        plain = LaunchTimer(sd.deposit_plain)
        with ExitStack() as es:
            patched(es, deposit=plain, full_sweep=ik.full_sweep_plain,
                    any_sweep=ik.any_sweep_plain,
                    sweep_closest=lambda *a: cv.intersect_curves_plain(*a),
                    sweep_any=lambda *a: cv.intersect_curves_plain(*a, any_hit=True))
            img_plain = go()
        torch.cuda.synchronize()
        part["plain_ms"] = plain.times_ms()
        err = compare_plain(f"{name} image", img, img_plain)
        # the card's busy share over a render of SPPM_WARM_ITERATIONS: the
        # profiler's post-processing of a whole render's ~700,000 device ops
        # would take minutes
        prof = profile_render(lambda: go(iterations=SPPM_WARM_ITERATIONS), f"{tag} profile")
        busy = sum(r[0] for r in prof)
        wk = part.pop("work0")
        print(f"[{tag}] {w}x{h}, {n_it} iterations, depth {depth}, {w * h} photons an "
              f"iteration: finite, matches the plain render (max abs err {err:.3g}, mean "
              f"{float(img.mean()):.5f}); launches {counts}; grid_bucket_overflow "
              f"{st['grid_bucket_overflow']}, grid_res_last {st['grid_res_last']}, final max_ev "
              f"{st['max_ev_last']}", flush=True)
        print(f"[{tag}] {rays_per_s:.6g} SPPM rays/s (w h iterations 2 / wall, bench.py:341; "
              f"{1e3 * st['wall_s']:.3f} ms after a warm render of {SPPM_WARM_ITERATIONS} "
              f"iterations) on {card}; a profiled render of {SPPM_WARM_ITERATIONS} iterations: "
              f"device busy {busy:.3f} ms", flush=True)
        print(f"[{tag}] every S1 launch against the plain deposit: m bit-equal, phi "
              + ("bit-equal" if part["exact"] else
                 f"bit-equal but on {part['hair_off']} hair VPs within rtol 1e-5 (max abs err "
                 f"{part['max_abs_err']:.3g})")
              + f"; launch 0: {wk['tested']} pairs tested, {wk['near']} near ({wk['hair_near']} "
              f"on hair)", flush=True)
        print(f"[{tag}] S1 per launch on the card "
              f"{sum(part['device_ms']) / n_it:.4f} ms (queued), events "
              f"{sum(part['ms']) / n_it:.4f} ms, bound "
              f"{sum(max(b) for b in part['bound']) / n_it:.4f} ms (bytes "
              f"{sum(b[0] for b in part['bound']) / n_it:.4f}, operations "
              f"{sum(b[1] for b in part['bound']) / n_it:.4f}), plain "
              f"{sum(part['plain_ms']) / n_it:.1f} ms; S1 {100 * sum(part['ms']) / (1e3 * st['wall_s']):.2f}"
              f"% of the render's wall time ({card})", flush=True)
        out[name] = dict(counts=counts, deposit=part, rays_per_s=rays_per_s, busy_ms=busy,
                         wall_s=st["wall_s"])
        del scene, camera, accel, img, img_plain

    # one iteration's deposit at a size users would call real
    scene, camera = caustic_scenes.caustic_only(DEPOSIT_RES, device=DEVICE)
    photons = DEPOSIT_RES[0] * DEPOSIT_RES[1]
    c1 = cfg._replace(extra=dict(cfg.extra, n_iterations=1, photons_per_iteration=photons))
    s1 = smpl.make_sampler(smpl.RANDOM, 1, DEPOSIT_RES)
    rec = LaunchTimer(wrapper("deposit"), keep=True)
    with ExitStack() as es:
        patched(es, deposit=rec)
        # the scan's depth the 16-iteration renders reach after their first overflow
        es.enter_context(mock.patch.object(sppm, "MAX_VPS_PER_CELL", sppm.MAX_VPS_CAP))
        img = rdr.render(scene, camera, c1, s1, accel=si.build_accel(scene, device=DEVICE))
        torch.cuda.synchronize()
    if len(rec.calls) != 1 or not torch.isfinite(img).all():
        fail(f"the {DEPOSIT_RES[0]}x{DEPOSIT_RES[1]} iteration launched S1 {len(rec.calls)} "
             "times or gave a non-finite image")
    _, a, _, o = rec.calls[0]
    work = {}
    want, plain_ms = timed_ms(lambda: sd.deposit_plain(*a, work=work))
    err, exact, off = check_deposit("the 2^20-photon S1 launch", a, o, want)
    packed = (*a[:4], *sd.pack_vps(*a[4:11]), a[11])
    dev_ms = queued_ms(lambda: sd.launch(*packed), 3)
    ev_ms = cuda_ms(lambda: sd.launch(*packed), 3)
    bound = s1_bound_ms(a, work)
    print(f"[16 deposit] caustic_only at {DEPOSIT_RES[0]}x{DEPOSIT_RES[1]}, {photons} photons, "
          f"one iteration: {a[0].shape[0]} events, {a[4].shape[0]} VPs, max_ev {a[11]}; "
          f"{work['tested']} pairs tested, {work['near']} near; S1 equal to the plain deposit "
          f"({'bit-equal' if exact else f'phi of {off} VPs within rtol 1e-5'}); on the card "
          f"{dev_ms:.4f} ms (queued), events {ev_ms:.4f} ms, bound {max(bound):.4f} ms (bytes "
          f"{bound[0]:.4f}, operations {bound[1]:.4f}), plain {plain_ms:.1f} ms ({card})",
          flush=True)
    out["deposit_1024"] = dict(ms=ev_ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=max(bound),
                               bound=bound, max_abs_err=err, exact=exact,
                               tested=work["tested"], near=work["near"])
    return out


SWEEP_NAMES = ("sobol_dims", "any_sweep", "full_sweep")


def best_of_3(go) -> dict:
    """The stats of the fastest of 3 calls go(stats) (warm renders)."""
    runs = []
    for _ in range(3):
        runs.append({})
        go(runs[-1])
    return min(runs, key=lambda st: st["wall_s"])


def check_sweep_launches(tag: str, rec: dict) -> dict:
    """Holds every recorded K1, K4 and K5 launch (LaunchTimer with keep) to
    its plain version on the same inputs (K1 bit-equal, K4 equal, K5 as in
    phase 6); returns each kernel's ms, bound and max_abs_err."""
    import torch

    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk

    part = {k: dict(ms=rec[k].times_ms(), bound=[], max_abs_err=0.0) for k in SWEEP_NAMES}
    for b, (_, a, kw, o) in enumerate(rec["sobol_dims"].calls):
        if not torch.equal(o, sk.sobol_dims_plain(*a, **kw)):
            fail(f"{tag} K1 launch {b} differs from its plain version")
        part["sobol_dims"]["bound"].append(k1_bound_ms(a[0].shape[0], *a[2:4]))
    for key, kind, kid, plain in (("any_sweep", "any", "K4", ik.any_sweep_plain),
                                  ("full_sweep", "full", "K5", ik.full_sweep_plain)):
        for b, (_, a, kw, o) in enumerate(rec[key].calls):
            err = check_isect(f"{tag} {kid} launch {b}", kind, o, plain(*a, **kw))
            part[key]["max_abs_err"] = max(part[key]["max_abs_err"], err)
            part[key]["bound"].append(isect_bound_ms(kind, a, o))
    return part


def plain_fns(**timers) -> dict:
    """Every wrapper of the config 4 and material renders swapped for its
    plain version (a LaunchTimer around it where timers names one)."""
    from rs_pbrt_tpu_torch.ops import fourier_bsdf as fb
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import medium_kernel as mk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk

    fns = dict(sobol_dims=sk.sobol_dims_plain, any_sweep=ik.any_sweep_plain,
               full_sweep=ik.full_sweep_plain, delta_track=mk.delta_track_plain,
               ratio_track=mk.ratio_track_plain, fourier_eval=fb.fourier_eval_plain,
               fourier_sample=fb.fourier_sample_plain)
    return {k: timers.get(k, v) for k, v in fns.items()}


def compare_plain(what: str, img, img_plain) -> float:
    """Fails unless a render is within rtol = atol = TOL of its plain
    render; returns the largest absolute difference."""
    import torch

    diff = (img - img_plain).abs()
    err = float(diff.max())
    if not torch.allclose(img, img_plain, rtol=TOL, atol=TOL):
        off = float((diff > TOL + TOL * img_plain.abs()).any(-1).float().mean())
        fail(f"{what} differs from the plain render by up to {err} ({100 * off:.3f}% of the "
             "pixels)")
    return err


def phase_sss(card):
    """Phase 17: BASELINE config 4 (tools/sss_scenes.sss_dragonette())
    through render.render: volpath at 512 spp in batches of 2^22 paths after
    a warm render of 8 spp (bench.py:288-306), its card's busy share over a
    profiled render of 8 spp; volpath and path at 16 spp, every K1, K4 and
    K5 launch and the image against their plain versions."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.tools import sss_scenes

    t0 = time.perf_counter()
    scene, camera = sss_scenes.sss_dragonette(SSS_RES, device=DEVICE)
    host_s = time.perf_counter() - t0
    depth = sss_scenes.CFG.max_depth
    w, h = SSS_RES
    lanes = sss_scenes.BENCH_LANES

    def go(integrator, spp, stats=None, max_lanes=rdr.MAX_LANES):
        c = sss_scenes.CFG._replace(integrator=integrator, spp=spp)
        return rdr.render(scene, camera, c, smpl.make_sampler(smpl.SOBOL, spp, SSS_RES),
                          max_lanes=max_lanes, stats=stats)

    def launched(integrator, batches=1):
        # volpath: 19 dims a bounce, 7 x 19 > 128, so one K1 launch a bounce
        # and the camera's; each of its depth + 1 bounces a closest hit and 4
        # probes (K5), NEE and the exit point's NEE (K4).  path: 15 x 6 dims
        # in one launch; depth bounces and the emit-only pass
        if integrator == "volpath":
            return dict(sobol=(depth + 2) * batches, full_sweep=5 * (depth + 1) * batches,
                        any_sweep=2 * (depth + 1) * batches)
        return dict(sobol=2, full_sweep=5 * depth + 1, any_sweep=2 * depth)

    warm = {}
    go("volpath", SSS_WARM_SPP, warm, lanes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    st = {}
    zero_counts()
    img = go("volpath", sss_scenes.BENCH_SPP, st, lanes)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expect_counts(**launched("volpath", st["batches"]))
    if counts != want:
        fail(f"launch counts of the 512 spp config 4 render {counts}, expected {want}")
    if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
        fail(f"config 4 image: shape {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
    paths = w * h * sss_scenes.BENCH_SPP
    print(f"[17 config 4] sss_dragonette {w}x{h}, volpath, depth {depth}, "
          f"{sss_scenes.BENCH_SPP} spp: {paths} paths in {st['batches']} batches of up to "
          f"{lanes}; launches {counts}; mean {float(img.mean()):.5f}; scene built in "
          f"{host_s:.3f} s (host)", flush=True)
    print(f"[17 config 4] {st['paths_per_s']:.6g} camera paths/s ({st['wall_s']:.3f} s after a "
          f"warm render of {SSS_WARM_SPP} spp in {warm['wall_s']:.3f} s); peak device memory "
          f"{peak / 2**30:.2f} GiB, {(peak - held) / min(paths, lanes):.1f} bytes a path of a "
          f"batch; on {card}", flush=True)
    prof = profile_render(lambda: go("volpath", SSS_WARM_SPP, max_lanes=lanes),
                          f"17 profile, volpath {SSS_WARM_SPP} spp")
    out = dict(bench=dict(counts=counts, paths_per_s=st["paths_per_s"], peak=peak,
                          busy_ms=sum(r[0] for r in prof)))
    for integrator in ("volpath", "path"):
        tag = f"17 {integrator}"
        rec = {k: LaunchTimer(wrapper(k), keep=True) for k in SWEEP_NAMES}
        with ExitStack() as es:
            patched(es, **rec)
            torch.cuda.synchronize()
            zero_counts()
            img = go(integrator, SSS_CHECK_SPP)
            torch.cuda.synchronize()
            counts = read_counts()
        if counts != expect_counts(**launched(integrator)):
            fail(f"launch counts of the {SSS_CHECK_SPP} spp {integrator} render {counts}, "
                 f"expected {launched(integrator)}")
        part = check_sweep_launches(tag, rec)
        del rec
        plain_t = {k: LaunchTimer(v) for k, v in plain_fns().items() if k in SWEEP_NAMES}
        with ExitStack() as es:
            patched(es, **plain_fns(**plain_t))
            img_plain = go(integrator, SSS_CHECK_SPP)
        torch.cuda.synchronize()
        err = compare_plain(f"config 4 {integrator} image", img, img_plain)
        for k in SWEEP_NAMES:
            part[k]["plain_ms"] = plain_t[k].times_ms()
        st = best_of_3(lambda stats: go(integrator, SSS_CHECK_SPP, stats))
        print(f"[{tag}] {w}x{h}, {SSS_CHECK_SPP} spp, depth {depth}: finite, matches the plain "
              f"render (max abs err {err:.3g}, mean {float(img.mean()):.5f}); launches {counts}; "
              f"every K1 launch bit-equal, K4 equal, K5 within {TOL}; {st['paths_per_s']:.6g} "
              f"camera paths/s (best of 3 warm renders, {1e3 * st['wall_s']:.3f} ms) on {card}",
              flush=True)
        for k, kid in (("sobol_dims", "K1"), ("full_sweep", "K5"), ("any_sweep", "K4")):
            p = part[k]
            print(f"[{tag}] {kid} per launch {sum(p['ms']) / len(p['ms']):.4f} ms (events, mean "
                  f"of {len(p['ms'])}), bound {sum(max(b) for b in p['bound']) / len(p['bound']):.4f}"
                  f" ms, plain {sum(p['plain_ms']) / len(p['plain_ms']):.3f} ms", flush=True)
        out[integrator] = dict(part, counts=counts, paths_per_s=st["paths_per_s"])
        del img, img_plain
    return out


def medium_bound_ms(key: str, args, work) -> tuple:
    """Least time of one M1 or M2 launch on these inputs, as (bytes_ms,
    operations_ms), from the plain version's work on the same inputs.
    Bytes: each ray's inputs and outputs (M_RAY_BYTES, M_OUT_BYTES), the
    distinct voxels the lookups read and the media's small tables, once.
    Operations: M_FLOP per step and per lookup."""
    import torch

    n = args[7].shape[0]
    voxels = (torch.unique(torch.cat(work["voxel_set"])).numel() if work.get("voxel_set")
              else 0)
    small = sum(a.numel() * 4 for a in args[1:5])
    nbytes = n * (M_RAY_BYTES + M_OUT_BYTES[key]) + 4 * voxels + small
    kind = "delta" if key == "delta_track" else "ratio"
    flop = (work.get("steps", 0) * M_FLOP[f"{kind}_step"]
            + work.get("lookups", 0) * M_FLOP[f"{kind}_lookup"])
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S, voxels


def check_medium(what: str, got, want) -> tuple:
    """Fails unless an M1 or M2 launch matches its plain version: M1's
    sampled equal, and every output bit-equal or, where not, within rtol =
    atol = 1e-5 (the line says which).  Returns (largest absolute
    difference, whether bit-equal)."""
    import torch

    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) == 3 and not torch.equal(got[0], want[0]):
        fail(f"{what}: sampled differs from the plain version on "
             f"{int((got[0] != want[0]).sum())} rays")
    floats = [(g, w_) for g, w_ in zip(got, want) if g.dtype == torch.float32]
    if all(torch.equal(g, w_) for g, w_ in floats):
        return 0.0, True
    err = max(float((g - w_).abs().max()) for g, w_ in floats)
    if not all(torch.allclose(g, w_, rtol=1e-5, atol=1e-5) for g, w_ in floats):
        fail(f"{what}: differs from the plain version by up to {err}")
    return err, False


def phase_smoke(card):
    """Phase 18: tools/sss_scenes.smoke_dragonette() (the camera in a
    128^3 grid medium) through render.render with volpath at 200x200, 16
    spp: every M1 and M2 launch against its plain version on the same
    inputs, timed by events and queued beside its bound and the plain
    version; every K1, K4 and K5 launch and the image against their plain
    versions."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import medium_kernel as mk
    from rs_pbrt_tpu_torch.tools import sss_scenes

    t0 = time.perf_counter()
    scene, camera = sss_scenes.smoke_dragonette(SMOKE_GRID_RES, resolution=SSS_RES,
                                                device=DEVICE)
    host_s = time.perf_counter() - t0
    cfg = sss_scenes.CFG._replace(spp=SSS_CHECK_SPP)
    scfg = smpl.make_sampler(smpl.SOBOL, SSS_CHECK_SPP, SSS_RES)
    depth, (w, h) = cfg.max_depth, SSS_RES
    names = SWEEP_NAMES + ("delta_track", "ratio_track")

    def go(stats=None):
        return rdr.render(scene, camera, cfg, scfg, stats=stats)

    go()  # warm
    rec = {k: LaunchTimer(wrapper(k), keep=True) for k in names}
    with ExitStack() as es:
        patched(es, **rec)
        torch.cuda.synchronize()
        zero_counts()
        img = go()
        torch.cuda.synchronize()
        counts = read_counts()
    launched = dict(sobol=depth + 2, full_sweep=5 * (depth + 1), any_sweep=2 * (depth + 1),
                    delta_track=depth + 1, ratio_track=depth + 1)
    if counts != expect_counts(**launched):
        fail(f"launch counts of the smoke render {counts}, expected {launched}")
    if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
        fail(f"smoke image: shape {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
    part = check_sweep_launches("18 smoke", rec)
    for key, kid in (("delta_track", "M1"), ("ratio_track", "M2")):
        plain = getattr(mk, f"{key}_plain")
        p = part[key] = dict(ms=rec[key].times_ms(), device_ms=[], bound=[], max_abs_err=0.0,
                             exact=True, voxels=[], steps=0, lookups=0)
        for b, (_, a, kw, o) in enumerate(rec[key].calls):
            work = {}
            err, exact = check_medium(f"smoke {kid} launch {b}", o, plain(*a, work=work))
            p["max_abs_err"] = max(p["max_abs_err"], err)
            p["exact"] &= exact
            bms, fms, voxels = medium_bound_ms(key, a, work)
            p["bound"].append((bms, fms))
            p["voxels"].append(voxels)
            p["steps"] += work["steps"]
            p["lookups"] += work["lookups"]
            p["device_ms"].append(queued_ms(lambda a=a: getattr(mk, key)(*a), 3))
    del rec
    plain_t = {k: LaunchTimer(getattr(mk, f"{k}_plain")) for k in ("delta_track", "ratio_track")}
    plain_t.update({k: LaunchTimer(v) for k, v in plain_fns().items() if k in SWEEP_NAMES})
    with ExitStack() as es:
        patched(es, **plain_fns(**plain_t))
        img_plain = go()
    torch.cuda.synchronize()
    err = compare_plain("smoke image", img, img_plain)
    for k in names:
        part[k]["plain_ms"] = plain_t[k].times_ms()
    st = best_of_3(go)
    print(f"[18 smoke] smoke_dragonette {w}x{h}, a {SMOKE_GRID_RES}^3 grid (scene built in "
          f"{host_s:.3f} s, host), volpath, {SSS_CHECK_SPP} spp, depth {depth}: finite, matches "
          f"the plain render (max abs err {err:.3g}, mean {float(img.mean()):.5f}); launches "
          f"{counts}; every K1 launch bit-equal, K4 equal, K5 within {TOL}; "
          f"{st['paths_per_s']:.6g} camera paths/s (best of 3 warm renders, "
          f"{1e3 * st['wall_s']:.3f} ms) on {card}", flush=True)
    for key, kid in (("delta_track", "M1"), ("ratio_track", "M2")):
        p = part[key]
        n = len(p["ms"])
        print(f"[18 {kid}] {n} launches of {w * h * SSS_CHECK_SPP} rays, every one against the "
              + ("plain version: bit-equal" if p["exact"] else
                 f"plain version: sampled equal, within rtol 1e-5 (max abs err "
                 f"{p['max_abs_err']:.3g})")
              + f"; {p['steps']} steps, {p['lookups']} lookups, distinct voxels per launch "
              f"{p['voxels']}", flush=True)
        print(f"[18 {kid}] per launch on the card {sum(p['device_ms']) / n:.4f} ms (queued), "
              f"events {sum(p['ms']) / n:.4f} ms, bound {sum(max(b) for b in p['bound']) / n:.4f}"
              f" ms (bytes {sum(b[0] for b in p['bound']) / n:.4f}, operations "
              f"{sum(b[1] for b in p['bound']) / n:.4f}), plain "
              f"{sum(p['plain_ms']) / n:.3f} ms; {kid} "
              f"{100 * sum(p['ms']) / (1e3 * st['wall_s']):.2f}% of the render's wall time "
              f"({card})", flush=True)
    return dict(part, counts=counts, paths_per_s=st["paths_per_s"])


def _env_counts(tag: str, spp: int, n_lights: int, depth: int = DEPTH) -> dict:
    """Phase 19's launch counts of a quadric_env render of one batch at
    `depth`: K1 for the camera and the integrator's dims, K5 a closest
    hit, K4 a shadow ray (a light sample, or an ao sample), S1 once an SPPM
    iteration; nothing else (K2's mega_cfg refuses quadrics and an
    environment)."""
    if tag == "path":  # the bounce dims of every bounce in one launch
        return dict(sobol=2, full_sweep=depth + 1, any_sweep=depth)
    if tag == "volpath":  # 11 dims a bounce x 6 bounces in one launch
        return dict(sobol=2, full_sweep=depth + 1, any_sweep=depth + 1)
    if tag == "ao":  # 64 samples' 128 dims in one launch
        return dict(sobol=2, full_sweep=1, any_sweep=64)
    if tag == "sppm":  # each iteration: camera dims and a block a depth;
        # camera and photon closest hits; one light's shadow ray a depth
        return dict(sobol=spp * (1 + depth), full_sweep=2 * depth * spp,
                    any_sweep=depth * spp, sppm_deposit=spp)
    return dict(sobol=1 + depth, full_sweep=depth,
                any_sweep=depth * (1 if tag == "directlighting one" else n_lights))


def phase_env(card):
    """Phase 19: tools/env_scenes.quadric_env() at 256x256 through
    render.render with each integrator (ENV_RUNS), each against its render
    with every wrapper swapped for its plain version; the 2-D search of the
    1024x2048 sky at 2^22 lanes."""
    import torch

    from rs_pbrt_tpu_torch.models import lights as lt
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import sampling as smp
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.ops import sppm_kernel as sd
    from rs_pbrt_tpu_torch.tools import env_scenes

    t0 = time.perf_counter()
    scene, camera = env_scenes.quadric_env(ENV_RES, sky_hw=ENV_SKY_HW, device=DEVICE)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    w, h = ENV_RES
    print(f"[19 quadric_env] {scene.n_tris} triangles, {scene.n_spheres} quadrics (kinds mask "
          f"{scene.quad_kind_mask}), {scene.n_lights} lights, a {ENV_SKY_HW[0]}x{ENV_SKY_HW[1]} "
          f"sky; built with its importance tables in {host_s:.3f} s", flush=True)
    plain = dict(plain_fns(), deposit=sd.deposit_plain)
    out = {}
    for tag, integrator, spp, extra in ENV_RUNS:
        cfg = rdr.RenderCfg(integrator, spp, DEPTH, 1.0, extra=extra)
        scfg = smpl.make_sampler(smpl.SOBOL, 1 if integrator == "sppm" else spp, ENV_RES)
        go = lambda stats=None: rdr.render(scene, camera, cfg, scfg, stats=stats)
        go()  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_counts()
        img = go()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        want = expect_counts(**_env_counts(tag, spp, scene.n_lights))
        if counts != want:
            fail(f"launch counts of the quadric_env {tag} render {counts}, expected {want}")
        if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
            fail(f"quadric_env {tag} image: shape {tuple(img.shape)}, finite "
                 f"{bool(torch.isfinite(img).all())}")
        with ExitStack() as es:
            patched(es, **plain)
            img_plain = go()
        torch.cuda.synchronize()
        err = compare_plain(f"quadric_env {tag} image", img, img_plain)
        del img_plain
        st = best_of_3(go)
        unit = "SPPM rays/s (w h iterations 2)" if integrator == "sppm" else "camera paths/s"
        rate = (w * h * spp * 2 / st["wall_s"] if integrator == "sppm" else st["paths_per_s"])
        print(f"[19 {tag}] {w}x{h}, {spp} {'iterations' if integrator == 'sppm' else 'spp'}, "
              f"depth {DEPTH}: finite, matches the plain render (max abs err {err:.3g}, mean "
              f"{float(img.mean()):.5f}); launches {counts}; {rate:.6g} {unit} (best of 3 warm "
              f"renders, {1e3 * st['wall_s']:.3f} ms); peak device memory "
              f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above the scene) on "
              f"{card}", flush=True)
        out[tag] = dict(counts=counts, rate=rate, peak=peak)
        if tag == "path":
            prof = profile_render(go, "19 profile, path", ranges={
                "quadric tests": (si, "sphere_hits"),
                "quadric records": (si, "sphere_interaction"),
                "sky sample": (lt, "_env_sample"),
                "sky pdf": (lt, "pdf_li_env"),
                "sky on escape": (lt, "env_le")})
            out[tag]["busy_ms"] = sum(r[0] for r in prof)
        del img
    # the sky's importance search at 2^22 lanes: no lane copies a row
    dist = scene.inf_dist
    u = torch.rand((SEARCH_LANES, 2), device=DEVICE, generator=torch.Generator(DEVICE)
                   .manual_seed(19))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ms = cuda_ms(lambda: smp.sample_distribution_2d(dist, u), 5)
    extra_bytes = torch.cuda.max_memory_allocated() - held
    row_bytes = SEARCH_LANES * dist.cond_cdf.shape[1] * 4
    print(f"[19 search] sample_distribution_2d at {SEARCH_LANES} lanes on the "
          f"{dist.cond_func.shape[0]}x{dist.cond_func.shape[1]} sky: {ms:.3f} ms a call (events, "
          f"mean of 5 after a warm call); it holds at most {extra_bytes / 2**20:.1f} MiB above "
          f"its inputs ({extra_bytes / SEARCH_LANES:.1f} bytes a lane; a row a lane would be "
          f"{row_bytes / 2**30:.1f} GiB) on {card}", flush=True)
    if extra_bytes >= row_bytes / 16:
        fail(f"the 2-D search held {extra_bytes} bytes at {SEARCH_LANES} lanes")
    out["search"] = dict(counts=expect_counts(), ms=ms, bytes=extra_bytes)
    return out


def phase_statue_env(card, statue):
    """Phase 20: tools/env_scenes.statue_env() (phase 9's statue and BVH
    under the sky) through render's defaults at 1024x1024, 16 spp
    (regeneration); then 2^18 paths of a crop through the regeneration loop
    against the fixed-depth loop, per path."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod
    from rs_pbrt_tpu_torch.models.integrators import regen
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import bvh
    from rs_pbrt_tpu_torch.tools import env_scenes

    t0 = time.perf_counter()
    scene, camera = env_scenes.statue_env(STATUE_ENV_RES, STATUE_SUBDIV, sky_hw=ENV_SKY_HW,
                                          device=DEVICE)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # the triangles are phase 9's, so its BVH serves
    if not torch.equal(scene.tri_attr, statue["scene"].tri_attr):
        fail("statue_env's triangles differ from phase 9's statue")
    accel = statue["accel"]
    print(f"[20 statue_env] {scene.n_tris} triangles (phase 9's BVH), {scene.n_lights} lights, a "
          f"{ENV_SKY_HW[0]}x{ENV_SKY_HW[1]} sky; scene built in {host_s:.3f} s (host)",
          flush=True)
    cfg = rdr.RenderCfg("path", STATUE_ENV_SPP, DEPTH, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, STATUE_ENV_SPP, STATUE_ENV_RES)
    w, h = STATUE_ENV_RES
    paths = w * h * STATUE_ENV_SPP
    go = lambda c=cfg, stats=None: rdr.render(scene, camera, c, scfg, accel=accel, stats=stats)
    go(cfg._replace(spp=1))  # warm
    overflow = bvh.overflow_counter(DEVICE)
    overflow.zero_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    st = {}
    zero_counts()
    img = go(stats=st)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if not st["lane_width"]:
        fail("the statue_env render did not take the regeneration loop")
    want = expect_counts(sobol=2 * st["batches"], bvh12_closest=st["iterations"],
                         bvh12_any=st["iterations"])
    if counts != want:
        fail(f"launch counts of the statue_env render {counts}, expected {want}")
    if int(overflow.item()):
        fail(f"the BVH traversal stack overflowed {int(overflow.item())} times under the sky")
    if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
        fail(f"statue_env image: shape {tuple(img.shape)}, finite "
             f"{bool(torch.isfinite(img).all())}")
    print(f"[20 statue_env] {w}x{h}, {STATUE_ENV_SPP} spp, depth {DEPTH}, {paths} paths through "
          f"{st['lane_width']} lanes, {st['iterations']} iterations; launches {counts}; stack "
          f"overflows 0; mean {float(img.mean()):.5f}; {st['paths_per_s']:.6g} camera paths/s "
          f"({st['wall_s']:.3f} s, after a warm render of 1 spp); peak device memory "
          f"{peak / 2**30:.2f} GiB ({(peak - held) / paths:.1f} bytes a path above the scene) "
          f"on {card}", flush=True)
    del img
    prof = profile_render(lambda: go(cfg._replace(spp=STATUE_ENV_PROFILE_SPP)),
                          f"20 profile, {STATUE_ENV_PROFILE_SPP} spp (regeneration)")
    # a crop's paths: the regeneration loop per path against the fixed-depth loop
    cw, ch = STATUE_ENV_CROP
    rect = ((h - ch) // 2, ch, (w - cw) // 2, cw)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, STATUE_ENV_SPP, rect)
    pcfg = pathmod.PathCfg(DEPTH, 1.0)
    n = rays.o.shape[0]
    rst = {}
    overflow.zero_()
    zero_counts()
    L = regen.radiance_regen(scene, pcfg, scfg, ctx, rays.o, rays.d, accel,
                             lane_width=REGEN_CHECK_WIDTH, stats=rst)
    torch.cuda.synchronize()
    crop_counts = read_counts()
    n_it = rst["iterations"]
    if crop_counts != expect_counts(sobol=1, bvh12_closest=n_it, bvh12_any=n_it):
        fail(f"launch counts of the statue_env regeneration check {crop_counts}")
    L_fixed = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, accel)
    torch.cuda.synchronize()
    fixed_counts = read_counts()
    path_err = float((L - L_fixed).abs().max())
    if int(overflow.item()) or not torch.isfinite(L).all():
        fail("the statue_env regeneration check overflowed its stack or is not finite")
    if not torch.allclose(L, L_fixed, rtol=1e-5, atol=1e-6):
        fail(f"statue_env: the regeneration loop's radiance differs from the fixed-depth loop's "
             f"by up to {path_err}")
    print(f"[20 regen] {n} paths of a {cw}x{ch} crop through {REGEN_CHECK_WIDTH} lanes: {n_it} "
          f"iterations; every path equals the fixed-depth loop's at rtol 1e-5, atol 1e-6 (max "
          f"abs err {path_err:.3g}, {int(torch.equal(L, L_fixed))} bit-equal); stack overflows 0",
          flush=True)
    # the render's launches and the regeneration check's (both loops)
    return dict(counts={k: counts[k] + fixed_counts[k] for k in counts},
                paths_per_s=st["paths_per_s"], peak=peak, busy_ms=sum(r[0] for r in prof))


# ---- phases 21-22: the other BxDFs ----

def grid_counts(tag: str, spp: int, n_lights: int, depth: int = DEPTH) -> dict:
    """Phase 21's launch counts of a material_grid render of one batch at
    `depth`: K1, K4, K5 and S1 as phase 19's (_env_counts); F2 once a BSDF
    sample (a bounce of the path and directlighting loops, each of
    volpath's depth + 1 vertices, a camera and a photon vertex of SPPM);
    F1 once a light sample (its f and pdf share one launch, as many as the
    shadow rays) and once a BSDF sample (f and pdf at the sampled wi).
    S1 evaluates SPPM's visible points' Fourier lobes itself."""
    c = _env_counts(tag, spp, n_lights, depth)
    samples = {"path": depth, "volpath": depth + 1, "sppm": 2 * depth * spp}.get(tag, depth)
    c.update(fourier_sample=samples, fourier_eval=c["any_sweep"] + samples)
    return c


def fourier_work(ft, wo, wi, on) -> dict:
    """The lanes of one F1 or F2 launch and the orders their sums take (the
    largest order of each lane's 16 cells, as the kernel stops) at (mu_i,
    mu_o) of wi: F1's wi, or for F2 the wi its sample lands on (the same
    cells serve its luminance series and its evaluation of f)."""
    import torch

    from rs_pbrt_tpu_torch.ops import fourier_bsdf as fb

    idx = torch.nonzero(on).flatten()
    MU = ft.mu.shape[0]
    _, off_i, _ = fb._cr_weights(ft.mu, -wi[idx, 2])
    _, off_o, _ = fb._cr_weights(ft.mu, wo[idx, 2])
    m_max = torch.zeros_like(idx)
    for b in range(4):
        for a in range(4):
            cell = (torch.clamp(off_o + b, 0, MU - 1) * MU + torch.clamp(off_i + a, 0, MU - 1))
            m_max = torch.maximum(m_max, ft.m[cell].long())
    return dict(lanes=int(idx.shape[0]), orders=int(torch.clamp(m_max, max=64).sum()),
                n=int(on.shape[0]))


def fourier_bound_ms(ft, work: dict, sample: bool) -> tuple:
    """Least time of one F1 or F2 launch, as (bytes_ms, operations_ms).
    Bytes: every lane's flag (on, 1) in and its outputs out (F1: f 12 and
    pdf 4; F2: wi 12); the lanes on the lobe's directions in (wo 12, and wi
    12 or u2 8), as the kernels read them only there; the table once.
    Operations: F_FLOP's terms per lane on the lobe and per order its sums
    take (work from fourier_work)."""
    table = sum(t.numel() * 4 for t in (ft.mu, ft.dense, ft.m, ft.cdf, ft.a0))
    n, lanes, orders = work["n"], work["lanes"], work["orders"]
    nbytes = n * (1 + (12 if sample else 16)) + lanes * (12 + (8 if sample else 12)) + table
    if sample:
        MU = ft.mu.shape[0]
        flop = lanes * (F_FLOP["sample_lane"] + MU * F_FLOP["cdf_entry"]) + orders * (
            F_FLOP["sample_order"])
    else:
        flop = lanes * F_FLOP["lane"] + orders * F_FLOP["order"]
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def check_fourier(what: str, got, want) -> tuple:
    """Fails unless a launch's outputs equal the plain version's, or are
    within rtol = atol = 1e-5 (bit_equal False, the line says which).
    Returns (max_abs_err, bit_equal)."""
    import torch

    err, exact = 0.0, True
    for g, w in zip(got, want):
        exact = exact and torch.equal(g, w)
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        if not torch.allclose(g, w, rtol=1e-5, atol=1e-5):
            fail(f"{what} differs from its plain version by up to {err}")
    return err, exact


def phase_grid(card):
    """Phase 21: tools/material_scenes.material_grid() at 256x256 through
    render.render with each integrator (GRID_RUNS), each against its render
    with every wrapper swapped for its plain version and its launch counts
    against grid_counts; then every F1 and F2 launch of the path render
    against its plain version, timed."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import bsdf as bx
    from rs_pbrt_tpu_torch.ops import fourier_bsdf as fb
    from rs_pbrt_tpu_torch.ops import fourier_kernel as fk
    from rs_pbrt_tpu_torch.ops import sppm_kernel as sd
    from rs_pbrt_tpu_torch.tools import material_scenes

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, camera = material_scenes.material_grid(GRID_RES, sky_hw=ENV_SKY_HW, device=DEVICE)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    w, h = GRID_RES
    ft = fb.table_of(scene)
    print(f"[21 material_grid] {scene.n_tris} triangles, {scene.n_spheres} spheres, "
          f"materials mask {scene.mat_kind_mask:#x}, a {ft.mu.shape[0]}-node Fourier table "
          f"(dense {tuple(ft.dense.shape)}, largest order {int(ft.m.max())}), a "
          f"{ENV_SKY_HW[0]}x{ENV_SKY_HW[1]} sky; built in {host_s:.3f} s", flush=True)
    plain = dict(plain_fns(), deposit=sd.deposit_plain)
    out = {}
    for tag, integrator, spp, extra in GRID_RUNS:
        cfg = rdr.RenderCfg(integrator, spp, DEPTH, 1.0, extra=extra)
        scfg = smpl.make_sampler(smpl.SOBOL, 1 if integrator == "sppm" else spp, GRID_RES)
        go = lambda stats=None: rdr.render(scene, camera, cfg, scfg, stats=stats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        timers = {}
        if tag == "path":  # keep F1's and F2's launches for their checks
            timers = {k: LaunchTimer(wrapper(k), keep=True)
                      for k in ("fourier_eval", "fourier_sample")}
        zero_counts()
        with ExitStack() as es:
            patched(es, **timers)
            img = go()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        want = expect_counts(**grid_counts(tag, spp, scene.n_lights))
        if counts != want:
            fail(f"launch counts of the material_grid {tag} render {counts}, expected {want}")
        if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
            fail(f"material_grid {tag} image: shape {tuple(img.shape)}, finite "
                 f"{bool(torch.isfinite(img).all())}")
        with ExitStack() as es:
            patched(es, **plain)
            img_plain = go()
        torch.cuda.synchronize()
        err = compare_plain(f"material_grid {tag} image", img, img_plain)
        del img_plain
        st = best_of_3(go)
        unit = "SPPM rays/s (w h iterations 2)" if integrator == "sppm" else "camera paths/s"
        rate = (w * h * spp * 2 / st["wall_s"] if integrator == "sppm" else st["paths_per_s"])
        print(f"[21 {tag}] {w}x{h}, {spp} {'iterations' if integrator == 'sppm' else 'spp'}, "
              f"depth {DEPTH}: finite, matches the plain render (max abs err {err:.3g}, mean "
              f"{float(img.mean()):.5f}); launches {counts}, as expected; "
              f"{rate:.6g} {unit} (best of 3 warm renders, {1e3 * st['wall_s']:.3f} ms); peak "
              f"device memory {peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above the "
              f"scene) on {card}", flush=True)
        out[tag] = dict(counts=counts, rate=rate, peak=peak)
        if tag == "path":
            prof = profile_render(go, "21 profile, path", ranges={
                "make_bsdf_at": (bx, "make_bsdf_at"), "bsdf_f": (bx, "bsdf_f"),
                "bsdf_pdf": (bx, "bsdf_pdf"), "bsdf_sample": (bx, "bsdf_sample"),
                "F1 fourier_eval": (fk, "fourier_eval"),
                "F2 fourier_sample": (fk, "fourier_sample")})
            out[tag]["busy_ms"] = busy = sum(r[0] for r in prof)
            out[tag]["timers"] = timers
            # F1 and F2 launch through their own libraries' runtime, whose
            # launches the profiler times but does not put in a range
            for kid, name in (("F1", "::eval_kernel("), ("F2", "::sample_kernel(")):
                ms = sum(r[0] for r in prof if name in r[2])
                print(f"[21 profile, path]   {kid} ({name[2:-1]}): {ms:.3f} ms of device time, "
                      f"{100 * ms / max(busy, 1e-9):.1f}% of the busy time", flush=True)
        del img
    # F1 and F2 on each launch's inputs of the path render
    for key, sample in (("fourier_eval", False), ("fourier_sample", True)):
        timer = out["path"]["timers"][key]
        plain_fn = getattr(fb, key + "_plain")
        part = dict(ms=timer.times_ms(), device_ms=[], plain_ms=[], bound=[], max_abs_err=0.0,
                    exact=True, lanes=0)
        for b, (_, a, kw, o) in enumerate(timer.calls):
            t0 = time.perf_counter()
            ref = plain_fn(*a, **kw)
            torch.cuda.synchronize()
            part["plain_ms"].append(1e3 * (time.perf_counter() - t0))
            if sample:  # F2 gives wi alone
                o, ref = (o,), (ref,)
            e, exact = check_fourier(f"material_grid path {key} launch {b}", o, ref)
            part["max_abs_err"] = max(part["max_abs_err"], e)
            part["exact"] = part["exact"] and exact
            part["device_ms"].append(queued_ms(lambda a=a: getattr(fk, key)(*a), 3))
            work = fourier_work(a[0], a[1], ref[0] if sample else a[2], a[3])
            part["lanes"] += work["lanes"]
            part["bound"].append(fourier_bound_ms(a[0], work, sample))
        n = len(timer.calls)
        if not n:
            fail(f"the material_grid path render launched no {key}")
        kid = "F2" if sample else "F1"
        print(f"[21 {kid}] {n} launches of {timer.calls[0][1][1].shape[0]} lanes "
              f"({part['lanes'] // n} a launch on the lobe): "
              f"{'bit-equal to' if part['exact'] else 'within 1e-5 of'} the plain version "
              f"(max abs err {part['max_abs_err']:.3g}"
              f"{'' if part['exact'] else '; the card and torch differ in the last bits'}); "
              f"on the card {sum(part['device_ms']) / n:.4f} ms (queued), events "
              f"{sum(part['ms']) / n:.4f} ms, bound {sum(max(x) for x in part['bound']) / n:.4f} "
              f"ms (bytes {sum(x[0] for x in part['bound']) / n:.4f}, operations "
              f"{sum(x[1] for x in part['bound']) / n:.4f}), plain {sum(part['plain_ms']) / n:.3f}"
              f" ms ({card})", flush=True)
        out[key] = part
    del out["path"]["timers"]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[21] {out['seconds']:.1f} s", flush=True)
    return out


def phase_statue_disney(card, statue):
    """Phase 22: tools/material_scenes.statue_disney() (phase 9's statue and
    BVH, the statue in a Disney material with clearcoat and sheen) through
    render's defaults at 1024x1024, 16 spp (regeneration); then 2^18 paths
    of a crop through the regeneration loop against the fixed-depth loop,
    per path."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod
    from rs_pbrt_tpu_torch.models.integrators import regen
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import bvh
    from rs_pbrt_tpu_torch.tools import material_scenes

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, camera = material_scenes.statue_disney(STATUE_ENV_RES, STATUE_SUBDIV, device=DEVICE)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    if not torch.equal(scene.tri_attr, statue["scene"].tri_attr):
        fail("statue_disney's triangles differ from phase 9's statue")
    accel = statue["accel"]
    print(f"[22 statue_disney] {scene.n_tris} triangles (phase 9's BVH), materials mask "
          f"{scene.mat_kind_mask:#x}; scene built in {host_s:.3f} s (host)", flush=True)
    spp = STATUE_ENV_SPP
    cfg = rdr.RenderCfg("path", spp, DEPTH, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, spp, STATUE_ENV_RES)
    w, h = STATUE_ENV_RES
    paths = w * h * spp
    go = lambda c=cfg, stats=None: rdr.render(scene, camera, c, scfg, accel=accel, stats=stats)
    go(cfg._replace(spp=1))  # warm
    overflow = bvh.overflow_counter(DEVICE)
    overflow.zero_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    st = {}
    zero_counts()
    img = go(stats=st)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if not st["lane_width"]:
        fail("the statue_disney render did not take the regeneration loop")
    want = expect_counts(sobol=2 * st["batches"], bvh12_closest=st["iterations"],
                         bvh12_any=st["iterations"])
    if counts != want:
        fail(f"launch counts of the statue_disney render {counts}, expected {want}")
    if int(overflow.item()) or tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
        fail(f"statue_disney: stack overflows {int(overflow.item())}, image shape "
             f"{tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
    print(f"[22 statue_disney] {w}x{h}, {spp} spp, depth {DEPTH}, {paths} paths through "
          f"{st['lane_width']} lanes, {st['iterations']} iterations; launches {counts}; stack "
          f"overflows 0; mean {float(img.mean()):.5f}; {st['paths_per_s']:.6g} camera paths/s "
          f"({st['wall_s']:.3f} s, after a warm render of 1 spp); peak device memory "
          f"{peak / 2**30:.2f} GiB ({(peak - held) / paths:.1f} bytes a path above the scene) "
          f"on {card}", flush=True)
    del img
    prof = profile_render(lambda: go(cfg._replace(spp=STATUE_ENV_PROFILE_SPP)),
                          f"22 profile, {STATUE_ENV_PROFILE_SPP} spp (regeneration)")
    cw, ch = STATUE_ENV_CROP
    rect = ((h - ch) // 2, ch, (w - cw) // 2, cw)
    ctx, rays = rdr.camera_rays(camera, scfg, 0, spp, rect)
    pcfg = pathmod.PathCfg(DEPTH, 1.0)
    n = rays.o.shape[0]
    rst = {}
    overflow.zero_()
    zero_counts()
    L = regen.radiance_regen(scene, pcfg, scfg, ctx, rays.o, rays.d, accel,
                             lane_width=REGEN_CHECK_WIDTH, stats=rst)
    torch.cuda.synchronize()
    crop_counts = read_counts()
    n_it = rst["iterations"]
    if crop_counts != expect_counts(sobol=1, bvh12_closest=n_it, bvh12_any=n_it):
        fail(f"launch counts of the statue_disney regeneration check {crop_counts}")
    L_fixed = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, accel)
    torch.cuda.synchronize()
    fixed_counts = read_counts()
    path_err = float((L - L_fixed).abs().max())
    if int(overflow.item()) or not torch.isfinite(L).all():
        fail("the statue_disney regeneration check overflowed its stack or is not finite")
    if not torch.allclose(L, L_fixed, rtol=1e-5, atol=1e-6):
        fail(f"statue_disney: the regeneration loop's radiance differs from the fixed-depth "
             f"loop's by up to {path_err}")
    seconds = time.perf_counter() - t_phase
    print(f"[22 regen] {n} paths of a {cw}x{ch} crop through {REGEN_CHECK_WIDTH} lanes: {n_it} "
          f"iterations; every path equals the fixed-depth loop's at rtol 1e-5, atol 1e-6 (max "
          f"abs err {path_err:.3g}, {int(torch.equal(L, L_fixed))} bit-equal); stack overflows 0;"
          f" phase 22 {seconds:.1f} s", flush=True)
    return dict(counts={k: counts[k] + fixed_counts[k] for k in counts},
                paths_per_s=st["paths_per_s"], peak=peak, busy_ms=sum(r[0] for r in prof),
                seconds=seconds)


def kernel_entry(name, source, replaces, launches, parts, max_abs_err, library_ms=None) -> dict:
    """One kernel's line of the `kernels` JSON: per-launch means over
    `parts`, dicts of per-launch lists ms, plain_ms and bound ((bytes_ms,
    operations_ms) pairs), and where the parts have it device_ms (the
    launches replayed back to back, without the host's share of a call)."""
    mean = lambda xs: sum(xs) / len(xs)
    ms = [t for p in parts for t in p["ms"]]
    plain_ms = [t for p in parts for t in p["plain_ms"]]
    bounds = [b for p in parts for b in p["bound"]]
    entry = dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=max_abs_err, ms=mean(ms), plain_ms=mean(plain_ms),
        bound_ms=mean([max(b) for b in bounds]),
        bound_by="operations" if sum(b[1] for b in bounds) >= sum(b[0] for b in bounds) else "bytes",
        library_ms=library_ms,
    )
    if all("device_ms" in p for p in parts):
        entry["device_ms"] = mean([t for p in parts for t in p["device_ms"]])
    return entry


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
    k2_err = phase_k2(card, scene, camera)
    flag = phase_render(card)
    flag["k1"]["max_abs_err"] = max(k1_err, flag["k1"]["max_abs_err"])
    flag["k2"]["max_abs_err"] = max(k2_err, flag["k2"]["max_abs_err"])
    sweeps = phase_sweeps(card)
    slices = [phase_slice_render(card, integrator) for integrator in ("directlighting", "whitted")]
    probe = phase_probe(card)
    statue = phase_statue(card)
    later = [phase_regen_check(card, statue)]
    # phase 20 reuses phase 9's statue and BVH, which go before phase 11
    later.append(phase_statue_env(card, statue))
    later.append(phase_statue_disney(card, statue))
    del statue["camera"], statue["scene"], statue["accel"]
    later += list(phase_spatial_crop(card).values())
    later.append(phase_full_statue(card))
    curves = phase_curves(card)
    hair = phase_hair_renders(card)
    later += list(hair.values())
    glass = phase_glass(card)
    later += list(glass.values())
    caustic = phase_sppm(card)
    later += [caustic["caustic_only"], caustic["caustic_hair"]]
    sss = phase_sss(card)
    later += [sss["bench"], sss["volpath"], sss["path"]]
    smoke = phase_smoke(card)
    later.append(smoke)
    later += list(phase_env(card).values())
    grid = phase_grid(card)
    later += [grid[tag] for tag, _, _, _ in GRID_RUNS]
    more = lambda key: sum(p["counts"][key] for p in later)  # phases 10-12 and 14-22's launches

    k2 = flag["k2"]
    csrc, pallas = "rs_pbrt_tpu_torch/csrc/", "rs_pbrt_tpu/ops/pallas_intersect.py:"
    worst = lambda key, *more: max([p["max_abs_err"] for p in more]
                                   + [r[key]["max_abs_err"] for r in slices])
    kernels = [
        dict(kernel_entry("sobol_dims", csrc + "sobol.cu", "rs_pbrt_tpu/ops/pallas_sobol.py:35",
                          flag["counts"]["sobol"] + sum(r["counts"]["sobol"] for r in slices)
                          + statue["counts"]["sobol"] + more("sobol"),
                          [flag["k1"]] + [r["sobol_dims"] for r in slices] + [statue["sobol_dims"]],
                          worst("sobol_dims", flag["k1"], statue["sobol_dims"])),
             redesigned=True),
        dict(name="bounce", route="cuda", source=csrc + "bounce.cu",
             replaces="rs_pbrt_tpu/ops/pallas_path.py:410",
             launches=flag["counts"]["bounce"] + more("bounce"),
             library_ms=None, **k2, redesigned=True),
        # K3 is on no render path: its numbers are phase 6's at the camera rays
        dict(kernel_entry("closest_sweep", csrc + "intersect.cu", pallas + "133", 0,
                          [sweeps["closest"]], sweeps["closest"]["max_abs_err"]),
             redesigned=True),
        dict(kernel_entry("any_sweep", csrc + "intersect.cu", pallas + "285",
                          sum(r["counts"]["any_sweep"] for r in slices) + more("any_sweep"),
                          [r["any_sweep"] for r in slices], worst("any_sweep", sweeps["any"])),
             redesigned=True),
        kernel_entry("full_sweep", csrc + "intersect.cu", pallas + "376",
                     sum(r["counts"]["full_sweep"] for r in slices) + more("full_sweep"),
                     [r["full_sweep"] for r in slices], worst("full_sweep", sweeps["full"])),
        # B1 and B2 replace an XLA function, the JAX package's TPU traversal
        dict(kernel_entry("bvh12_closest", csrc + "bvh12.cu", "rs_pbrt_tpu/ops/bvh.py:994",
                          statue["counts"]["bvh12_closest"] + more("bvh12_closest"),
                          [statue["closest"]],
                          statue["closest"]["max_abs_err"]),
             redesigned=True),
        dict(kernel_entry("bvh12_any", csrc + "bvh12.cu", "rs_pbrt_tpu/ops/bvh.py:994",
                          statue["counts"]["bvh12_any"] + more("bvh12_any"), [statue["any"]],
                          statue["any"]["max_abs_err"]),
             redesigned=True),
        dict(kernel_entry("take_rows", csrc + "gather_probe.cu", "tools/tpu_probe.py:110",
                          probe["counts"]["take_rows"], [probe["take_rows"]],
                          probe["take_rows"]["max_abs_err"], library_ms=probe["gather_ms"]),
             redesigned=True, launch_floor_ms=probe["launch_floor_ms"]),
        dict(kernel_entry("take_loop", csrc + "gather_probe.cu", "tools/tpu_probe.py:132",
                          probe["counts"]["take_loop"], [probe["take_loop"]],
                          probe["take_loop"]["max_abs_err"]),
             redesigned=True),
    ]
    # C1-C4 replace the JAX package's XLA curve intersection
    for name, scene_key, replaces in (
            ("walk_closest", "fur_patch", "rs_pbrt_tpu/ops/curves.py:409"),
            ("walk_any", "fur_patch", "rs_pbrt_tpu/ops/curves.py:409"),
            ("sweep_closest", "hair_patch", "rs_pbrt_tpu/ops/curves.py:387"),
            ("sweep_any", "hair_patch", "rs_pbrt_tpu/ops/scene_intersect.py:767")):
        part = hair[scene_key][name]
        kernels.append(dict(kernel_entry(
            f"curve_{name}", csrc + "curves.cu", replaces, more(f"curve_{name}"), [part],
            max(part["max_abs_err"], curves[name]["max_abs_err"])),
            bit_equal=part["exact"] and curves[name]["exact"]))
    # S1 replaces the JAX package's XLA photon deposit
    parts = [caustic[k]["deposit"] for k in ("caustic_only", "caustic_hair")]
    d1024 = caustic["deposit_1024"]
    kernels.append(dict(kernel_entry(
        "sppm_deposit", csrc + "sppm.cu", "rs_pbrt_tpu/models/integrators/sppm.py:295",
        more("sppm_deposit"), parts, max([p["max_abs_err"] for p in parts] + [d1024["max_abs_err"]])),
        bit_equal=all(p["exact"] for p in parts) and d1024["exact"],
        deposit_1024={k: d1024[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "tested",
                                            "near")}))
    # M1 and M2 replace the JAX package's XLA tracking loops; no one PyTorch
    # call computes them
    for key, line in (("delta_track", 57), ("ratio_track", 86)):
        kernels.append(dict(kernel_entry(
            key, csrc + "medium.cu", f"rs_pbrt_tpu/models/integrators/volpath.py:{line}",
            more(key), [smoke[key]], smoke[key]["max_abs_err"]), bit_equal=smoke[key]["exact"]))
    # F1 and F2 replace the JAX package's XLA Fourier BSDF; no one PyTorch
    # call computes them
    for key, line in (("fourier_eval", 212), ("fourier_sample", 249)):
        kernels.append(dict(kernel_entry(
            key, csrc + "fourier.cu", f"rs_pbrt_tpu/ops/fourier_bsdf.py:{line}", more(key),
            [grid[key]], grid[key]["max_abs_err"]), bit_equal=grid[key]["exact"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
