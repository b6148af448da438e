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
   seconds; a warm render of 1 spp, then one timed render of 1024x1024, 32
   spp (FULL_SPP; bench.py:252-277 renders 64), depth 5 with regeneration.  The counters are
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
14. The hair renders through render.render at 200x200, 8 spp, path,
   depth 3 (HAIR_SPP, HAIR_DEPTH; the scenes' own CFG has 16 and 5):
   tools/hair_scenes
   .hair_patch() (the fixed-depth loop: K1 2, K5 4, K4 3, C3 4, C4 3,
   nothing else; every launch held to its plain
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
   their own settings but 2 iterations (SPPM_ITERATIONS; the files' 16)
   (200x200, depth 5, one photon a pixel
   an iteration, the random sampler), timed as bench.py:336-341 times
   them (a warm render of 2 iterations, then the timed render; SPPM
   rays/s = w h iterations 2 / wall), the counters zeroed just before the
   timed render and read just after (S1 2, K5 20, K4 10; C3 20 and C4 10
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
   render.render at 256x256, depth 3 (ENV_DEPTH): path, directlighting
   ("all" and "one") and whitted at 64 spp, ao (64 samples) and volpath at
   16 spp, SPPM of 4 iterations.  The counters are zeroed just before each
   render and read just after: K1, K4 and K5 as each integrator draws and
   casts (path: K1 2, K5 4, K4 3; SPPM also S1 once an iteration), K2 never
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
   1024x2048 sky) through render.render at 256x256, depth 3: path,
   directlighting ("all") and volpath at 16 spp, SPPM of 4 iterations.  The counters are zeroed just before each render and
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

23. tools/texture_scenes.texture_grid() (a checker of a seeded 1000x750
   image map and an fbm on the floor, nine spheres binding every texture
   slot and family, a bump map, an alpha-masked and a shadow-alpha quad, a
   projection and a goniometric light) through render.render at 256x256,
   depth 3: path, directlighting ("all") and volpath at 16 spp, SPPM of 4
   iterations.  The counters are zeroed just before each
   render and read just after; they must equal texture_counts (K1, K5, S1 and T1
   by formula from the integrator and the alpha recasts' trips, read
   through a wrapper of scene_intersect.alpha_recast_loop; K4 never: with
   alpha masks a shadow ray takes the closest hit and the recast loop).
   Each image finite and within rtol = atol = 2e-3 of the render with
   every wrapper swapped for its plain version; the trips and the lanes
   still masked after 16; paths/s (SPPM rays/s) best of 3 warm renders,
   peak memory; the busy share of one profiled path render with the device
   time in make_bsdf_at, apply_bump, the recast loop and T1.  Every T1
   launch of the path render held to its plain version (bit-equal, else
   within 1e-5, the line says which), timed queued and by events beside
   its bound (texture_work: each lane's family, octaves and texels) and the
   plain version's time; then one T1 launch at 2^22 lanes over the grid's
   bound textures (seeded uv, points and footprints), the same way.
24. tools/texture_scenes.statue_marble(): phase 9's statue and BVH in a
   plastic with a marble kd and an fbm bump map (no image map, so it
   regenerates), through render's defaults at 1024x1024, 16 spp: K1 2,
   B1 = B2 = the iterations, T1 twice an iteration (the kd and the bump
   map) on its 2^21-lane launches; paths/s beside statue_env's and
   statue_disney's of this call, peak memory, the busy share of a
   profiled 4 spp render; then the 128x128 crop's 2^18 paths through the
   regeneration loop at 2^14 lanes against the fixed-depth loop within
   rtol 1e-5, atol 1e-6.  It runs right after phase 22.
25. The other samplers: H1 (ops/halton_kernel.py, csrc/halton.cu) on
   seeded 32-bit indices at the main paths' shapes (4M lanes x the camera's
   5 dims and a path's 35, the clipped route's dims 250-300, one launch's
   128 dims).  Then the Cornell box at RES, SPP, DEPTH through path with
   the Sobol' sampler on the general bounce (K2's mega_cfg patched to
   refuse it) and with halton, zerotwo, stratified and maxmin; the same
   box with Halton and with Sobol' through volpath, whitted and
   directlighting; caustic_only with SPPM at SPPM_RES, 4 iterations, with
   Halton and with Sobol'; phase 9's statue with Halton at STATUE_RES,
   STATUE_SPP through the fixed-depth loop.  The counters are zeroed just
   before each render and read just after (H1 once for the camera dims and
   once a block of integrator dims, K1 likewise for Sobol', the sweeps or
   the traversal as in the earlier phases).  Each image finite; each
   Halton image equal to the render with H1 swapped for its plain version;
   paths/s (SPPM rays/s) of one render after a warm one, and the mean
   beside the Sobol' render's.  Every H1 launch held bit-equal to its plain
   version, timed queued and by events beside its bound (the digits each
   lane's index has in each dim's base) and the plain version's time.  It
   runs right after phase 24, before phase 9's statue is freed.

26. The other cameras and filters: the Cornell box at RES, SPP, DEPTH
   through path with the Mitchell filter (the flagship's camera), the
   realistic camera (tests/test_realistic.py's singlet, an 8 mm aperture,
   focused at 1078, a 35 mm film diagonal) with the Gaussian filter, and the
   orthographic, environment and moving perspective cameras on the grid
   film.  The counters are zeroed just before each render and read just
   after: K1 1, K2 depth + 1, R1 (ops/splat_kernel.py, csrc/splat.cu) once
   where the filter is not the half-pixel box, L1 (ops/lens_kernel.py,
   csrc/lens.cu) once for the realistic camera.  Each image finite and
   within rtol = atol = 2e-3 of the render with every wrapper swapped for
   its plain version; paths/s (best of 3 warm renders) and the card's busy
   time over a profiled render.  Every R1 launch held to the plain splat
   per pixel within 2 n 2^-24 of its n summed |terms| (atomics add in no
   fixed order), every L1 launch to its plain version (the same vignetted
   lanes, bit-equal or within 1e-5; the line says which), each timed
   queued and by events beside its bound and the plain version's time;
   then R1 with each filter kind at its default radius and L1 on the
   singlet with a stop behind it (both weightings), on the realistic
   render's lanes.

27. Instancing, object motion and the kd-tree
   (tools/instance_scenes.py): the forest (an 81,920-triangle prototype
   instanced 64 times on an 8x8 lattice, 5,242,880 triangles in view) at
   1024x1024, 16 spp, path, depth 5, through the regeneration loop; the
   Cornell box with a moving icosphere(3) (1,280 triangles, shutter 0-1) at
   RES, SPP, DEPTH, which takes the general bounce (mega_cfg refuses it);
   and the statue at subdivisions 4 (5,124 triangles) through its kd-tree
   at RES, SPP.  The counters are zeroed just before each render and read
   just after (I1 and I2, ops/instance_kernel.py and csrc/instance.cu, once
   an iteration; V1, ops/motion_kernel.py and csrc/motion.cu, depth + 1
   closest and depth any; D1 and D2, ops/kdtree_kernel.py and
   csrc/kdtree.cu, once an iteration).  I1 and I2 held bit-equal to their
   plain walks on the first and last launch of each, every V1, D1 and D2
   launch likewise, each timed queued and by events beside its bound (the
   nodes, candidates and triangles the plain walk visits) and the plain
   version's time.  Paths/s, peak memory, the forest's tables beside the
   bytes of its triangles stored flat, the share of camera rays that enter
   more instance boxes than the walk keeps (K_CANDIDATES), the card's busy
   share over a profiled 4 spp forest render, the kd build's host seconds,
   nodes, leaf cap and stack overflows (0), and the kd image against the
   same render through the BVH (B1/B2) within 2e-3.

28. BDPT and MLT (models/integrators/bdpt.py, mlt.py) through
   render.render: BDPT on the Cornell box at RES, SPP, DEPTH in one batch,
   MLT there at MLT_MPP mutations per pixel with MLT_CHAINS chains and
   MLT_BOOTSTRAP bootstrap samples, and BDPT on phase 18's smoke at
   SMOKE_BDPT_RES, SMOKE_BDPT_SPP, depth SMOKE_BDPT_DEPTH (M1 in the walks,
   M2 in the connections).  The counters are zeroed just before each
   render and read just after: K1 2 a batch (the camera's dims and one
   block of the rest; MLT none), K5 a walk vertex (2 depth + 1), K4 a
   strategy with a shadow ray, W1 (ops/mis_kernel.py, csrc/mis.cu) a
   strategy, M1 and M2 as K5 and K4 in the smoke; MLT's a BDPT evaluation
   a bootstrap chunk, the chain starts and each mutation.  Each image
   finite and within rtol = atol = 2e-3 of its render with every wrapper
   swapped for its plain version (MLT from the same generator seed).
   Every K1, K4, K5, M1, M2 and W1 launch held to its plain version (W1
   bit-equal), W1's timed queued and by events beside its bound (the 9
   bytes of each vertex a lane walks, its overrides and 4 out) and the
   plain version's time.  BDPT paths/s (best of 3 warm renders), the card's
   busy share over a profiled render and the bytes a lane holds at the
   render's peak; MLT mutations/s and paths/s of one timed render.

29. Gradients and checkpoints (diff/grad.py, diff/geometry.py, render's
   checkpoints).  The counters are zeroed just before each gradient render
   and read just after.  The main gradient render: the Cornell box at
   GRAD_RES, GRAD_SPP spp, depth GRAD_DEPTH, grad_loss(mean) over
   DiffParams: K1 2, K5 depth + 1, K4 depth, K2 0 (refused under a
   gradient); its gradient within rtol = atol = 2e-3 x max|g| of the same
   gradient with every wrapper swapped for its plain version; the white
   walls' kd red within 5e-2 of a central difference (renders through K2);
   forward-and-backward paths/s (best of 3), the peak memory and bytes a
   lane, the busy share of a profiled gradient render.  The camera
   gradient at depth GRAD_CAM_DEPTH: K3 on detached rays a cast and G1
   (ops/hit_grad_kernel.py, csrc/hit_grad.cu) a bounce's hit (the last
   cast only collects emission, whose MIS weight is detached); the
   translation's y and z within 0.08 of central differences over the
   pixels none of whose samples changes a hit triangle or a shadow ray's
   occlusion between the base and the stepped renders (the samples that
   do are counted: they carry the boundary term detached sampling leaves
   out).  A quad
   textured by a 1024x1024 image map (its pyramid read through the rays'
   footprints): T1 and T2 (ops/texture_kernel.py, csrc/texture_grad.cu)
   once each.  The Cornell box with the Mitchell filter: R1 and R2
   (ops/splat_kernel.py, csrc/splat_grad.cu) once each.  Every G1 launch
   held to its plain twin (per lane bit-equal or within 1e-5, the vertex
   gradients within 2 n 2^-24 of their summed |terms|), every T2 launch
   (each entry within 1e-3 + 1e-5 x max), every R2 launch (per lane
   bit-equal or within 1e-5), each timed queued and by events beside its
   bound and the twin's time.  grad_loss_wrt_translation of the tall box
   (TRANS_RES, TRANS_SPP spp, depth 1, the loss on the rows above the
   floor's, as tests/test_grad.py:178-237 does for the short box):
   interior plus the mean boundary of TRANS_SEEDS seeds, with the sign of
   the central difference and within rtol 0.5 of it.  A render
   checkpointed after half its batches and resumed, bit-equal to the
   uninterrupted render over the same batches.  Then grad_loss_wrt_camera
   of the five scene kinds whose backward passes came with A17c part 1,
   each at A17C_RES, A17C_SPP spp: the Cornell box through the realistic
   camera (depth 2; L1 traces in camera space, the pose applied in
   PyTorch), a quad moving 0.3 in x (depth 1; V1 on detached rays, G1 in
   the mesh's object space), a quad image-mapped by a seeded A17C_IMAGE
   image (depth 1; T1 forward, T3 (csrc/texture_grad.cu) backward in uv,
   p and the footprint), the hair patch through the curve sweep C3 and
   through its curve tree C1 (depth 1; C5, csrc/curve_grad.cu, the
   backward of both) and phase 18's smoke (sss_scenes.smoke_dragonette:
   the milk sphere on its floor, the camera in its SMOKE_GRID_RES^3 grid)
   with volpath (depth 1; M1's select, M2 forward and M3,
   csrc/medium_grad.cu, backward; the subsurface exit's Fresnel on the
   camera rays that reach the sphere).  Each render's counters are zeroed just
   before it and read just after, and its kernels must have launched; each
   gradient is finite and within rtol = atol = 2e-3 x max|g| of the same
   gradient with every wrapper swapped for its plain version, C1's within
   that of C3's; every T3, C5 and M3 launch is held to its twin (each
   entry within 1e-3 of it + 1e-5 of the largest) and timed queued and by
   events beside its bound and the twin's time.

30. Sharding (parallel/mesh.py, parallel/distributed.py).  A world of one
   over NCCL in this process (make_mesh() starts it): the flagship of phase
   5 through render(mesh=), the counters zeroed just before it and read
   just after (K1 once, K2 depth + 1 times), K1 held bit-equal and every
   K2 launch within TOL of its plain version, the image bit-equal to phase
   5's; its paths/s beside render's without the mesh, best of 3 in turns,
   and the film's all-reduce timed alone.  geometry_sharded_intersect on
   phase 6's 262,144 random rays and 2,048 triangles (one shard: K3 once)
   equal to K3 on the whole table, with K3's time.  BDPT, SPPM and MLT on
   a 64x64 Cornell box with the mesh: the same launches as without it and
   the image within rtol 1e-4, atol 1e-5 (splats and deposits add with
   atomics).  grad_loss(mesh=) of phase 29's main gradient: K1 2, K5
   depth + 1, K4 depth, within rtol 1e-5 of phase 29's.  Then a world of
   two processes on the one card over gloo (NCCL takes no two ranks on one
   card; gloo moves CUDA tensors itself, through host memory): each renders
   its band of the flagship at 16 spp (K1 1, K2 depth + 1 a rank) and sweeps
   its half of the triangles; the image within rtol 1e-4 of render's, the
   hits equal to K3 on the whole table.  The ranks are joined against a
   deadline and killed on a failure.

31. The .pbrt front end (scene/parser.py, scene/api.py, main.py): main()
   called in this process on three versions of assets/scenes/cornell_box.pbrt
   (500x500, 8 spp, Sobol', path to depth 5, box filter): (a) as written,
   whose default spatial light selection takes the general bounce (K1 2,
   K5 depth + 1, K4 depth); (b) with "string lightsamplestrategy" "power"
   on its Integrator line (K1 once, K2 depth + 1 times, as phase 5); (c)
   without its Sampler line, so Halton (H1 2, K5, K4, no K2).  For each, the
   counters zeroed just before main and read just after must equal those
   of a direct render.render of the same load_pbrt result, main's PNG must
   equal write_png of that render byte for byte, and the render must be
   within rtol = atol = 2e-3 of the render with every wrapper swapped for
   its plain version; the parse-and-build seconds and the direct (warm)
   render's camera paths/s are printed.  Then the other four assets are
   loaded on the card through load_pbrt, without a render, and their sizes
   printed.

After each phase (or group) a "[time]" line gives the seconds since the
card was found.  Then one JSON line with every kernel's numbers, and as
the last line
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
# phases 14 and 16 below the scenes' own settings (16 spp, depth 5; 16 SPPM
# iterations): their plain checks cost dispatch and plain walks, which grow
# with the paths, bounces and iterations, and the script keeps to 1200 s
HAIR_SPP, HAIR_DEPTH, SPPM_ITERATIONS = 8, 3, 2
FUR_LANE_WIDTH = 1 << 18  # the fur render's regeneration lanes: its 320,000 paths
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
# (tag, integrator, spp, extra); depth GRID_DEPTH; sppm's spp is its iterations
GRID_RUNS = (("path", "path", 16, None),
             ("directlighting all", "directlighting", 16, dict(strategy="all")),
             ("volpath", "volpath", 16, None),
             ("sppm", "sppm", 4, dict(n_iterations=4)))
# phases 19, 21 and 23 render at depth 3, not DEPTH: the cut that keeps
# the script inside its time limit (each path still takes every bounce
# kind); 21 and 23 leave whitted out (on these scenes its image is
# directlighting's, and phases 7, 15 and 19 hold it), 21 renders 16 spp
GRID_DEPTH = TEX_DEPTH = ENV_DEPTH = 3
# F1 and F2's operations (ops/fourier_bsdf.py, counted as the bounds
# below count): F1's lane: its weights, cos phi, transform and pdf (~120);
# an order of its sums: 3 channels x 16 taps x 2 and the recurrence
# (~100); F2's lane: the 4-row interpolation's search, 12 Newton steps and
# the direction (~600) plus each cdf entry's interpolation (8); an order of
# its luminance taps and 20 Newton steps of the sine/cosine recurrence
# (~32 + 20 x 8)
F_FLOP = dict(lane=120, order=100, sample_lane=600, cdf_entry=8, sample_order=192)
# phases 23-24: tools/texture_scenes.py at BASELINE config 2's width
TEX_RES = (256, 256)
# (tag, integrator, spp, extra); depth TEX_DEPTH; sppm's spp is its iterations
TEX_RUNS = (("path", "path", 16, None),
            ("directlighting all", "directlighting", 16, dict(strategy="all")),
            ("volpath", "volpath", 16, None),
            ("sppm", "sppm", 4, dict(n_iterations=4)))
TEX_SWEEP_LANES = 1 << 22  # phase 23: one T1 launch over the grid's texture mix
# T1's operations (ops/texture.py, counted as the bounds below count; the
# integer hash steps count one): a Perlin noise's floors, offsets, 8
# gradients of 2 index adds, 2 masks and an add each, 3 weights of 9 and 7
# lerps of 4 (~120); an octave's p * lambda, o * n, the sum and o * omega
# (6) beside its noise; the 3D mapping's point transform (23); a marble's
# scale, displacement, sine and spline (45); a bilinear tap's wrap, weight
# and 3 products and sums (11) and its set-up (9); a footprint's log2,
# level and blend (15); the uv mapping (4); a combinator's own work
TEX_FLOP = dict(noise=120, octave=6, xform=23, marble=45, tap=11, lookup=9, trilinear=15,
                uv=4, value=3, scale=3, mix=12, checker=4, dots=20)
TEX_LANE_BYTES = 4 + 12  # id in, rgb out
TEX_POINT_BYTES = 8 + 12  # uv, p in: once a point, or once a lane where each row has its own
TEXEL_BYTES = 12
M_FLOP = dict(delta_step=83, ratio_step=44, delta_lookup=81, ratio_lookup=83)
M_RAY_BYTES = 4 + 1 + 12 + 12 + 4 + 4  # mid, in_med, o, d, t_max or dist, the lane key
M_OUT_BYTES = dict(delta_track=1 + 4 + 12, ratio_track=4)  # sampled, t, weight; tr
SMEM_LOADS_PER_CLOCK = 32  # shared-memory loads per clock per SM
VERT_BYTES = 9 * 4  # the vertex coordinates K3 and K4 read of a table row


# phase 25: the other samplers; H1's cases (lanes, dim0, n_dims, clip)
SAMPLER_KINDS = ("halton", "zerotwo", "stratified", "maxmin")
H1_CASES = ((1 << 22, 0, 5, False), (1 << 22, 5, 35, False), (1 << 20, 250, 51, True),
            (1 << 18, 5, 128, False))
SAMPLER_SPPM_ITERATIONS = 4
# H1's arithmetic (csrc/halton.cuh): a digit step divides, multiplies and
# subtracts for the digit, multiplies and adds for the reversed digits and
# multiplies the f32 scale; a (lane, dim) takes 1/base, the tail's product,
# difference and quotient, the sum, the product, the conversion and the
# clamp.  Integer operations are charged at the 32-bit rate, as K1's.
H1_OPS = dict(digit=6, dim=8)
# phase 26: the other cameras and filters on the flagship's Cornell box at
# RES, SPP, DEPTH; (tag, camera, filter kind at its default radius)
CAMERA_RUNS = (("mitchell", "perspective", 3), ("realistic gaussian", "realistic", 2),
               ("orthographic", "orthographic", 0), ("environment", "environment", 0),
               ("motion", "motion", 0))
# the biconvex singlet of tests/test_realistic.py:16 (mm rows: radius,
# thickness, eta, aperture diameter), and the same with an aperture stop
# behind it, cut to the 8 mm aperture (L1's stop branch)
SINGLET = (50.0, 5.0, 1.5, 20.0, -50.0, 45.0, 1.0, 20.0)
STOPPED = SINGLET[:4] + (-50.0, 5.0, 1.0, 20.0, 0.0, 40.0, 0.0, 12.0)
CORNELL_VIEW = ((278, 273, -800), (278, 273, 0), (0, 1, 0))
# R1's arithmetic (csrc/splat.cuh): a lane's two first-tap offsets (2
# subtractions each); an axis factor's tap offset (2) and the kind's own
# ops (box none; triangle 1; Gaussian 2 products, exp and a difference;
# Mitchell the quotient, 2v, x^2, x^3, both cubics and their sixths; sinc 2
# quotients, 2 products and sines and quotients, the window's product); a
# tap in the film with a nonzero weight: the factors' product, w L (3) and
# the 4 atomic adds
R1_OPS = dict(lane=4, offset=2, tap=8, kinds=(0, 1, 4, 16, 9))
R1_LANE_BYTES = 8 + 12  # p_film and L in
R1_PIXEL_BYTES = 2 * (12 + 4)  # the film's rgb and weight, read and written once
# L1's arithmetic (csrc/lens.cuh): a lane's film point, pupil bin and lerp,
# rear point, world transform and normalization, cos^4 weight (96); a
# spherical element reached (intersection, normal, aperture test,
# refraction: 81); a stop reached (11)
L1_OPS = dict(lane=96, sphere=81, stop=11)
L1_LANE_BYTES = 16 + 28  # p_film, u_lens in; o, d, weight out
# phase 27: the forest, the moving box and the kd statue
FOREST_SUBDIV, FOREST_GRID, FOREST_RES, FOREST_SPP = 6, 8, (1024, 1024), 16
FOREST_PROFILE_SPP = 4  # the profiled forest render
KD_SUBDIV = 4  # the kd statue: 5,124 triangles
# I1/I2, D1/D2 and V1's bounds (the plain walks count the work on each
# launch's rays): a binary node's two boxes (48 B) and child refs (8 B); a
# candidate's world-to-object rows (48 B); a triangle's vertices (36 B); a
# kd node's axis, split, above, start and count (20 B) and a leaf entry's
# prim id (4 B).  Operations: a ray's 1/d (3), a box's slab (13), a
# candidate's transforms and shear (50), a triangle test (65), a kd node's
# plane distance (2); V1's set-up a ray and group from tools/op_count.py
# (motion_ops) and 65 a test
WALK_NODE_BYTES, W2O_BYTES, TRI_BYTES, KD_NODE_BYTES, PRIM_ID_BYTES = 56, 48, 36, 20, 4
WALK_FLOP = dict(ray=3, box=13, candidate=50, tri=65, kd_node=2)
TIME_BYTES = 4
# phase 28: MLT at a quarter of the JAX render's default mutations a pixel
# (16: its plain render's sweeps grow with the mutations, and the script
# keeps to 1200 s with phase 30), 2^16 chains and 2^18 bootstrap samples;
# BDPT on the smoke at a reduced size
MLT_MPP, MLT_CHAINS, MLT_BOOTSTRAP = 4, 1 << 16, 1 << 18
SMOKE_BDPT_RES, SMOKE_BDPT_SPP, SMOKE_BDPT_DEPTH = (100, 100), 4, 3
# W1's bound: pdf_fwd, pdf_rev and delta of each vertex a lane walks, an
# override value (a delta override's byte), the origin's delta test, the
# weight out; a ratio's multiply and divide and a sum's add a vertex, the
# final add and divide
MIS_VERTEX_BYTES, MIS_OUT_BYTES, MIS_OPS_PER_VERTEX, MIS_OPS_PER_LANE = 9, 4, 3, 2
# phase 29: gradients and checkpoints.  The main gradient render: the
# Cornell box at the flagship's size, 16 spp, depth 3 (1,048,576 paths);
# the camera gradient at depth 2 (tests/test_grad.py's); the textured quad
# at 256x256, depth 1, on a 1024x1024 image map; the translation gradient
# of the tall box at tests/test_grad.py:178-237's size and samples
GRAD_RES, GRAD_SPP, GRAD_DEPTH, GRAD_CAM_DEPTH = (256, 256), 16, 3, 2
QUAD_RES, QUAD_SPP, QUAD_IMAGE = (256, 256), 16, (1024, 1024)
TRANS_RES, TRANS_SPP, TRANS_EDGE_SAMPLES, TRANS_SEEDS, TRANS_STEPS = 48, 64, 384, 6, (3.0, 6.0)
TALL_BOX = slice(20, 30)  # presets.cornell_build's tall box (walls 0-9, short box 10-19)
CK_BATCH_SPP = 4  # the checkpointed render's batches
FD_RTOL, CAM_FD_RTOL, TRANS_RTOL = 5e-2, 0.08, 0.5  # tests/test_grad.py's limits
CAM_FD_STEP = 0.05  # tests/test_grad.py:81-120's camera step
# G1's arithmetic (csrc/hit_grad.cu) a lane with a triangle: the forward
# test again (1/dz, the shear 2, a vertex's q 3 + x, y 4 + zs 1, the edges
# 9, det 2, t 5, 1/det: ~44) and its reverse sweep (g_inv 5, g_det 3, the
# edges' 11, gx and gy 18, a vertex's 15, gd 11: ~93)
G1_OPS = 137
G1_LANE_BYTES = 12 + 12 + 4 + 12 + 24  # o, d, tri, the 3 upstream gradients in; g_o, g_d out
# R2's arithmetic: R1's lane and factor work (R1_OPS) and a tap in the film
# with a nonzero weight: the factors' product and 3 products and sums
R2_TAP_OPS = 7
R2_LANE_BYTES = 8 + 12 + 12  # p_film and L in, g_L out
# phase 29.7: the camera gradients through textures, the lens, moving
# meshes, curves and a grid medium, each scene at 128x128, 4 spp (65,536
# paths); the image-mapped quad's seeded image; the hair patch's curve tree
# built above this many segments (its 48 are walked).  The smoke is phase
# 18's scene, its grid SMOKE_GRID_RES^3
A17C_RES, A17C_SPP, A17C_IMAGE, A17C_TREE_ABOVE = (128, 128), 4, (256, 256), 16
# T3's arithmetic: T1's (texture_work) twice, its lookup again and the
# reverse sweep; its bytes those of T1's lanes, points and texels with the
# coordinates' gradients (uv 8, p 12 a point, the width 4 a lane) out
T3_OUT_POINT_BYTES, T3_OUT_WIDTH_BYTES = 8 + 12, 4
# C5's arithmetic a hit lane (csrc/curve_grad.cu): the leaf test's forward
# terms (~250, curve.cuh's count less the rejects) and the reverse sweep
# (~300: the outputs 25, the Bernstein point 40, the ribbon width 30, the
# chord 20, the control points in the frame 96, the frame's cross products
# and normalizations 70, d's 20)
C5_OPS = 550
C5_HIT_LANE_BYTES = 12 + 12 + 4 + 16 + 24  # o, d, seg, 4 upstream gradients in; g_o, g_d out
C5_MISS_LANE_BYTES = 4 + 24  # seg in; g_o, g_d (zeros) out
C5_ROW_BYTES = 26 * 4
# M3's arithmetic: M2's steps and lookups (M_FLOP) in the forward, then a
# live step's 8 taps again and its reverse (the taps' weight differences
# 24, the point's gradient through w2m 30, the product's 3, o and d 6)
M3_REVERSE_OPS = M_FLOP["ratio_lookup"] + 63
M3_EXTRA_RAY_BYTES = 4 + 24 - 4  # g_tr in and g_o, g_d out instead of tr out
M3_IDLE_LANE_BYTES = 1 + 4 + 24  # in_med, g_tr in; g_o, g_d (zeros) out
# phase 30: sharding.  The world of two renders the flagship at 16 spp; the
# world of one's BDPT, SPPM and MLT checks run on a 64x64 Cornell box
SHARD_SPP, SHARD_WORLD, SHARD_DEADLINE = 16, 2, 300
SHARD_SMALL_RES, SHARD_SMALL_SPP, SHARD_SMALL_DEPTH = (64, 64), 4, 3
SHARD_MLT = dict(mutations_per_pixel=2, chains=1 << 12, bootstrap_samples=1 << 14)
SHARD_TOL = 1e-4  # atomics' sums (splats, deposits, gradients) against one device's


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
    from rs_pbrt_tpu_torch.ops import halton_kernel as hk
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import medium_kernel as mk
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.ops import sppm_kernel as sd
    from rs_pbrt_tpu_torch.ops import texture_kernel as tk
    from rs_pbrt_tpu_torch.ops import splat_kernel as rk
    from rs_pbrt_tpu_torch.ops import lens_kernel as lk
    from rs_pbrt_tpu_torch.ops import instance_kernel as ink
    from rs_pbrt_tpu_torch.ops import motion_kernel as mok
    from rs_pbrt_tpu_torch.ops import kdtree_kernel as kdk
    from rs_pbrt_tpu_torch.ops import mis_kernel as wk
    from rs_pbrt_tpu_torch.ops import hit_grad_kernel as hg

    return sk, pk, ik, bvh, gp, ck, sd, mk, fk, tk, hk, rk, lk, ink, mok, kdk, wk, hg


def zero_counts():
    """Every kernel's launch count to 0."""
    sk, pk, ik, bvh, gp, ck, sd, mk, fk, tk, hk, rk, lk, ink, mok, kdk, wk, hg = _kernel_modules()
    sk.launches = pk.launches = hk.launches = rk.launches = lk.launches = wk.launches = 0
    hg.launches = rk.grad_launches = 0
    for d in (ik.launches, bvh.launches, gp.launches, ck.launches, sd.launches, mk.launches,
              fk.launches, tk.launches, ink.launches, mok.launches, kdk.launches):
        d.update(dict.fromkeys(d, 0))


def read_counts() -> dict:
    sk, pk, ik, bvh, gp, ck, sd, mk, fk, tk, hk, rk, lk, ink, mok, kdk, wk, hg = _kernel_modules()
    return dict(sobol=sk.launches, bounce=pk.launches, halton=hk.launches, splat=rk.launches,
                lens=lk.launches, mis=wk.launches, hit_grad=hg.launches,
                splat_grad=rk.grad_launches, **ik.launches,
                **{f"bvh12_{k}": v for k, v in bvh.launches.items()}, **gp.launches,
                **ck.launches, **sd.launches, **mk.launches, **fk.launches, **tk.launches,
                **{f"instance_{k}": v for k, v in ink.launches.items()},
                **{f"motion_{k}": v for k, v in mok.launches.items()},
                **{f"kd_{k}": v for k, v in kdk.launches.items()})


def expect_counts(**launched) -> dict:
    """The counts of a run that launches only the kernels named."""
    return {**dict.fromkeys(read_counts(), 0), **launched}


def _owner(name: str):
    """The module of the kernel wrapper `name` (sobol_dims, bounce,
    closest_sweep, any_sweep, full_sweep, bvh12_intersect_tris, take_rows,
    take_loop, walk_closest, walk_any, sweep_closest, sweep_any, deposit,
    delta_track, ratio_track, fourier_eval, fourier_sample, texture_eval, halton_dims, splat,
    lens_rays, instance_intersect, anim_hits, kd_intersect, mis_weight, hit_vjp,
    texture_grad, splat_grad, texture_coord_grad, curve_vjp, ratio_track_vjp)."""
    sk, pk, ik, bvh, gp, ck, sd, mk, fk, tk, hk, rk, lk, ink, mok, kdk, wk, hg = _kernel_modules()
    return dict(sobol_dims=sk, bounce=pk, closest_sweep=ik, any_sweep=ik, full_sweep=ik,
                bvh12_intersect_tris=bvh, take_rows=gp, take_loop=gp, walk_closest=ck,
                walk_any=ck, sweep_closest=ck, sweep_any=ck, deposit=sd, delta_track=mk,
                ratio_track=mk, fourier_eval=fk, fourier_sample=fk, texture_eval=tk,
                halton_dims=hk, splat=rk, lens_rays=lk, instance_intersect=ink,
                anim_hits=mok, kd_intersect=kdk, mis_weight=wk, hit_vjp=hg, texture_grad=tk,
                splat_grad=rk, texture_coord_grad=tk, curve_vjp=ck, ratio_track_vjp=mk)[name]


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
            # anonymous-namespace kernels:
            # _ZN<n>_GLOBAL__N__<hash>_<n>_<file>_cu_<8 characters><n><kernel>E..
            k = re.search(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_\w{8}(\d+)", name)
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
        counts=counts, err=err, img=img, paths_per_s=best["paths_per_s"],
        k1=dict(ms=[k1_ms], device_ms=[k1_dev], plain_ms=p1t.times_ms(), bound=[k1_bound],
                max_abs_err=k1_err),
        k2=dict(ms=sum(k2_ms) / len(k2_ms), plain_ms=sum(p2_ms) / len(p2_ms),
                bound_ms=sum(k2_bounds) / len(k2_bounds), bound_by=k2_by, max_abs_err=k2_err),
    )


def phase_sweeps(card):
    """Phase 6: K3, K4, K5 against their plain versions, timed (events
    around calls as the host makes them, and on the card alone: device_ms,
    queued; the plain version by events around the call its check makes),
    with their bounds, on tools/sweep_replay.sweep_inputs.
    Returns, per kind, the camera rays' numbers and the worst error."""
    import torch

    from rs_pbrt_tpu_torch.tools import sweep_replay

    out = {}
    for name, args in sweep_replay.sweep_inputs(DEVICE).items():
        for kind, kid, fn, plain in sweep_replay.sweep_kernels():
            got = fn(*args)
            want, plain_ms = timed_ms(lambda: plain(*args))
            err = check_isect(f"{kid} {name}", kind, got, want)
            del want
            ms = cuda_ms(lambda: fn(*args), 20)
            dev_ms = queued_ms(lambda: fn(*args), 20)
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
        counts=counts, scene=scene, camera=camera, accel=accel, paths_per_s=best["paths_per_s"],
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
    """Phase 12: the 5.24M-triangle statue at 1024x1024, FULL_SPP spp,
    through render's defaults (regeneration)."""
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

    cfg = hair_scenes.CFG._replace(spp=HAIR_SPP, max_depth=HAIR_DEPTH)
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

    cfg = caustic_scenes.CFG._replace(extra=dict(caustic_scenes.CFG.extra,
                                                 n_iterations=SPPM_ITERATIONS))
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
    """Every wrapper of the config 4, material and texture renders swapped
    for its plain version (a LaunchTimer around it where timers names one)."""
    from rs_pbrt_tpu_torch.ops import fourier_bsdf as fb
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import medium_kernel as mk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.ops import texture_kernel as tk

    fns = dict(sobol_dims=sk.sobol_dims_plain, any_sweep=ik.any_sweep_plain,
               full_sweep=ik.full_sweep_plain, delta_track=mk.delta_track_plain,
               ratio_track=mk.ratio_track_plain, fourier_eval=fb.fourier_eval_plain,
               fourier_sample=fb.fourier_sample_plain, texture_eval=tk.plain)
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
        cfg = rdr.RenderCfg(integrator, spp, ENV_DEPTH, 1.0, extra=extra)
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
        want = expect_counts(**_env_counts(tag, spp, scene.n_lights, ENV_DEPTH))
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
              f"depth {ENV_DEPTH}: finite, matches the plain render (max abs err {err:.3g}, mean "
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
        cfg = rdr.RenderCfg(integrator, spp, GRID_DEPTH, 1.0, extra=extra)
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
        want = expect_counts(**grid_counts(tag, spp, scene.n_lights, GRID_DEPTH))
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
              f"depth {GRID_DEPTH}: finite, matches the plain render (max abs err {err:.3g}, mean "
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


# ---- phases 23-24: textures, bump maps, alpha masks ----

def texture_counts(tag: str, spp: int, n_lights: int, trips: int, depth: int = DEPTH) -> dict:
    """Phase 23's launch counts of a texture_grid render of one batch at
    `depth`, its alpha recasts' trips given: K1 and S1 as phase 19's
    (_env_counts); every cast, closest or shadow, one K5 (with alpha masks a
    shadow ray takes the closest hit and the recast loop, so K4 never runs)
    and one T1 for its mask test, each recast trip one K5 and one T1; T1
    once a BSDF (path's and the direct integrators' depth, volpath's depth
    + 1 vertices, SPPM's camera and photon vertices) and, in path, once a
    bounce for the bump map's three evaluations."""
    c = _env_counts(tag, spp, n_lights, depth)
    casts = c["full_sweep"] + c["any_sweep"]
    shading = {"path": depth, "volpath": depth + 1, "sppm": 2 * depth * spp}.get(tag, depth)
    bump = depth if tag == "path" else 0
    c.update(full_sweep=casts + trips, any_sweep=0,
             texture_eval=shading + bump + casts + trips)
    return c


def texture_work(tb, ids, uv, width) -> dict:
    """The work of one T1 launch on ids (S, N) at uv (N, 2) shared by the
    rows or (S, N, 2) a row's own, as its plain version does it on each
    lane's own family: operations (TEX_FLOP per noise, octave, lookup,
    tap), atlas texels read, lanes, the uv and p read (the points with a
    texture, or the lanes with one where each row has its own) and the
    points with a texture."""
    import torch

    from rs_pbrt_tpu_torch.ops import texture as tx

    f = TEX_FLOP
    n_tex = tb.type.shape[0]
    on = ids >= 0
    tid = torch.clamp(ids, 0, n_tex - 1).long()[on]
    ttype = tb.type[tid]
    combo = torch.isin(ttype, torch.tensor([tx.TEX_SCALE, tx.TEX_MIX, tx.TEX_CHECKER,
                                            tx.TEX_DOTS], device=ids.device))
    child = torch.clamp(tb.child[tid[combo]], 0, n_tex - 1).long().flatten()
    leaves = torch.cat([tid[~combo], child])
    lt = tb.type[leaves]
    octs = torch.clamp(tb.params[leaves, tx.TP_OCTAVES].to(torch.int64), 1, tx.MAX_OCTAVES)
    has = lambda t: bool(tb.kind_mask & (1 << t))
    count = lambda t: int((lt == t).sum()) if has(t) else 0
    octaves = lambda t: int(octs[lt == t].sum()) if has(t) else 0
    per_octave = f["noise"] + f["octave"]
    ops = sum((f["xform"] + 3) * count(t) + per_octave * octaves(t)
              for t in (tx.TEX_FBM, tx.TEX_WRINKLED))
    ops += (f["xform"] + f["marble"]) * count(tx.TEX_MARBLE) + per_octave * octaves(tx.TEX_MARBLE)
    ops += (f["xform"] + 7 + 9 * per_octave) * count(tx.TEX_WINDY)
    ops += (f["uv"] + 2) * count(tx.TEX_UV)
    n_img = count(tx.TEX_IMAGEMAP)
    taps = 8 if width is not None else 4
    lookups = 2 if width is not None else 1
    ops += n_img * (f["uv"] + f["value"] + lookups * f["lookup"] + taps * f["tap"]
                    + (f["trilinear"] if width is not None else 0))
    ct = ttype[combo]
    for t, k in ((tx.TEX_SCALE, f["scale"]), (tx.TEX_MIX, f["mix"]),
                 (tx.TEX_CHECKER, f["uv"] + f["checker"]),
                 (tx.TEX_DOTS, f["uv"] + f["dots"] + 3 * f["noise"])):
        ops += k * int((ct == t).sum())
    return dict(ops=ops, texels=n_img * taps, lanes=int(ids.numel()),
                points=int(on.sum() if uv.dim() == 3 else on.any(0).sum()),
                live=int(on.any(0).sum()), width=width is not None)


def texture_bound_ms(tb, work: dict) -> tuple:
    """Least time of one T1 launch, as (bytes_ms, operations_ms).  Bytes:
    each lane's id in and rgb out; the uv and p of each point with a
    texture (of each such lane where the rows have their own, as the
    bump's) and its footprint (width is (N,) always); 12 a texel the lanes
    fetch, at most the whole atlas; the tables once.  Operations:
    texture_work's."""
    tables = sum(t.numel() * t.element_size() for t in (
        tb.type, tb.params, tb.child, tb.w2t, tb.rect, tb.mip, tb.nlv, tb.perm))
    points = work["points"] * TEX_POINT_BYTES
    width = 4 * work["live"] if work["width"] else 0
    texels = min(work["texels"] * TEXEL_BYTES, tb.atlas.numel() * tb.atlas.element_size())
    nbytes = work["lanes"] * TEX_LANE_BYTES + points + width + texels + tables
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * work["ops"] / FP32_FLOP_PER_S


def check_texture(what: str, got, want, args=None) -> tuple:
    """Fails unless a T1 launch's output equals the plain version's, or is
    within rtol = atol = 1e-5 (bit_equal False).  (max_abs_err, exact);
    args (the launch's inputs) unread."""
    return check_fourier(what, (got,), (want,))


def _alpha_recorder(stats: dict):
    """scene_intersect's alpha_recast_loop, summing each call's trips and
    the lanes left masked into stats."""
    from rs_pbrt_tpu_torch.ops import scene_intersect as si

    real = si.alpha_recast_loop
    return lambda *a, **kw: real(*a, **kw, stats=stats)


def kernel_part(timer, tag: str, kid: str, plain, wrapper, bound, check, lanes) -> dict:
    """Every launch that timer recorded held to plain (the kernel's plain
    version) by check(what, got, want, args) -> (max_abs_err, exact), args
    the launch's inputs, replayed
    queued through wrapper for its device time; bound(*args, **kw) its
    (bytes_ms, operations_ms) and lanes(*args, **kw) its lanes."""
    import torch

    part = dict(ms=timer.times_ms(), device_ms=[], plain_ms=[], bound=[], max_abs_err=0.0,
                exact=True, lanes=0)
    for b, (_, a, kw, o) in enumerate(timer.calls):
        t0 = time.perf_counter()
        ref = plain(*a, **kw)
        torch.cuda.synchronize()
        part["plain_ms"].append(1e3 * (time.perf_counter() - t0))
        e, exact = check(f"{tag} {kid} launch {b}", o, ref, a)
        part["max_abs_err"] = max(part["max_abs_err"], e)
        part["exact"] = part["exact"] and exact
        part["device_ms"].append(queued_ms(lambda a=a, kw=kw: wrapper(*a, **kw), 3))
        part["bound"].append(bound(*a, **kw))
        part["lanes"] += lanes(*a, **kw)
        del ref
    return part


def print_part(kid: str, tag: str, part: dict, card: str, tol: str = "1e-5"):
    n = len(part["ms"])
    print(f"[{tag} {kid}] {n} launches, {part['lanes'] // max(n, 1)} lanes a launch: "
          f"{'bit-equal to' if part['exact'] else f'within {tol} of'} the plain version (max "
          f"abs err {part['max_abs_err']:.3g}); on the card {sum(part['device_ms']) / n:.4f} ms "
          f"(queued), events {sum(part['ms']) / n:.4f} ms, bound "
          f"{sum(max(x) for x in part['bound']) / n:.4f} ms (bytes "
          f"{sum(x[0] for x in part['bound']) / n:.4f}, operations "
          f"{sum(x[1] for x in part['bound']) / n:.4f}), plain {sum(part['plain_ms']) / n:.3f} "
          f"ms ({card})", flush=True)


def _t1_ids(a):
    return a[1] if a[1].dim() == 2 else a[1][None]


def t1_part(timer, tag: str) -> dict:
    """Every recorded T1 launch held to its plain version (check_texture),
    its bound from texture_work."""
    from rs_pbrt_tpu_torch.ops import texture_kernel as tk

    return kernel_part(
        timer, tag, "T1", tk.plain, tk.texture_eval,
        lambda *a, **kw: texture_bound_ms(a[0], texture_work(
            a[0], _t1_ids(a), a[2], kw.get("width", a[4] if len(a) > 4 else None))),
        check_texture, lambda *a, **kw: _t1_ids(a).numel())


def phase_textures(card):
    """Phase 23: tools/texture_scenes.texture_grid() at 256x256 through
    render.render with each integrator (TEX_RUNS), each against its render
    with every wrapper swapped for its plain version and its launch counts
    against texture_counts; every T1 launch of the path render against its
    plain version, timed; one T1 launch at TEX_SWEEP_LANES lanes."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import bsdf as bx
    from rs_pbrt_tpu_torch.ops import differentials as rd
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.ops import sppm_kernel as sd
    from rs_pbrt_tpu_torch.ops import texture as tx
    from rs_pbrt_tpu_torch.ops import texture_kernel as tk
    from rs_pbrt_tpu_torch.scene import arrays as sa
    from rs_pbrt_tpu_torch.tools import texture_scenes

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, camera = texture_scenes.texture_grid(TEX_RES, device=DEVICE)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    w, h = TEX_RES
    tb = tx.tables_of(scene)
    print(f"[23 texture_grid] {scene.n_tris} triangles, {scene.n_spheres} spheres, "
          f"{tb.type.shape[0]} textures (kinds {scene.tex_kind_mask:#x}, slots "
          f"{scene.tex_slot_mask:#x}), a {tuple(tb.atlas.shape)} atlas, {scene.n_lights} lights "
          f"(types {scene.light_type_mask:#x}), alpha masks {scene.has_alpha}, differentials "
          f"{rd.needs_diffs(scene)}; built in {host_s:.3f} s (host: the 1000x750 image's "
          f"Lanczos resample and pyramid)", flush=True)
    plain = dict(plain_fns(), deposit=sd.deposit_plain)
    out = {}
    for tag, integrator, spp, extra in TEX_RUNS:
        cfg = rdr.RenderCfg(integrator, spp, TEX_DEPTH, 1.0, extra=extra)
        scfg = smpl.make_sampler(smpl.SOBOL, 1 if integrator == "sppm" else spp, TEX_RES)
        go = lambda stats=None: rdr.render(scene, camera, cfg, scfg, stats=stats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        timers = {}
        if tag == "path":  # keep T1's launches for their checks
            timers = {"texture_eval": LaunchTimer(wrapper("texture_eval"), keep=True)}
        alpha = {}
        zero_counts()
        with ExitStack() as es:
            patched(es, **timers)
            es.enter_context(mock.patch.object(si, "alpha_recast_loop", _alpha_recorder(alpha)))
            img = go()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        want = expect_counts(**texture_counts(tag, spp, scene.n_lights, alpha["alpha_trips"], TEX_DEPTH))
        if counts != want:
            fail(f"launch counts of the texture_grid {tag} render {counts}, expected {want}")
        if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
            fail(f"texture_grid {tag} image: shape {tuple(img.shape)}, finite "
                 f"{bool(torch.isfinite(img).all())}")
        with ExitStack() as es:
            patched(es, **plain)
            img_plain = go()
        torch.cuda.synchronize()
        err = compare_plain(f"texture_grid {tag} image", img, img_plain)
        del img_plain
        st = best_of_3(go)
        unit = "SPPM rays/s (w h iterations 2)" if integrator == "sppm" else "camera paths/s"
        rate = (w * h * spp * 2 / st["wall_s"] if integrator == "sppm" else st["paths_per_s"])
        print(f"[23 {tag}] {w}x{h}, {spp} {'iterations' if integrator == 'sppm' else 'spp'}, "
              f"depth {TEX_DEPTH}: finite, matches the plain render (max abs err {err:.3g}, mean "
              f"{float(img.mean()):.5f}); launches {counts}, as expected; alpha recasts "
              f"{alpha['alpha_trips']} trips, {alpha['alpha_left']} lanes still masked after "
              f"{si.MAX_ALPHA_RECASTS}; {rate:.6g} {unit} (best of 3 warm renders, "
              f"{1e3 * st['wall_s']:.3f} ms); peak device memory {peak / 2**30:.2f} GiB "
              f"({(peak - held) / 2**30:.2f} GiB above the scene) on {card}", flush=True)
        out[tag] = dict(counts=counts, rate=rate, peak=peak, alpha=alpha)
        if tag == "path":
            prof = profile_render(go, "23 profile, path", ranges={
                "make_bsdf_at": (bx, "make_bsdf_at"), "apply_bump": (bx, "apply_bump"),
                "alpha_recast_loop": (si, "alpha_recast_loop"),
                "T1 texture_eval": (tk, "texture_eval")})
            out[tag]["busy_ms"] = busy = sum(r[0] for r in prof)
            ms = sum(r[0] for r in prof if "texture_kernel(" in r[2])
            print(f"[23 profile, path]   T1 (texture_kernel): {ms:.3f} ms of device time, "
                  f"{100 * ms / max(busy, 1e-9):.1f}% of the busy time", flush=True)
            out[tag]["timer"] = timers["texture_eval"]
        del img
    out["texture_eval"] = t1_part(out["path"].pop("timer"), "23 texture_grid path")
    print_part("T1", "23", out["texture_eval"], card)
    # one launch over the grid's texture mix: every bound texture id, seeded
    # uv, points in the grid's box and footprints
    g = torch.Generator(DEVICE).manual_seed(23)
    bound = torch.unique(torch.round(scene.mat_attr[:, sa.MA_TEX:]).to(torch.int32))
    bound = bound[bound >= 0]
    n = TEX_SWEEP_LANES
    ids = bound[torch.randint(0, bound.numel(), (1, n), device=DEVICE, generator=g)]
    uv = torch.rand((n, 2), device=DEVICE, generator=g)
    p = (torch.rand((n, 3), device=DEVICE, generator=g) - 0.5) * torch.tensor(
        [8.0, 4.0, 8.0], device=DEVICE)
    width = torch.exp(torch.rand(n, device=DEVICE, generator=g) * 12.0 - 12.0)
    sweep = LaunchTimer(tk.texture_eval, keep=True)
    sweep(tb, ids, uv, p, width)
    out["sweep"] = t1_part(sweep, f"23 T1 at {n} lanes")
    print_part("T1", f"23 sweep {n} lanes", out["sweep"], card)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[23] {out['seconds']:.1f} s", flush=True)
    return out


def phase_statue_marble(card, statue):
    """Phase 24: tools/texture_scenes.statue_marble() (phase 9's statue and
    BVH in a plastic with a marble kd and an fbm bump map, no image map)
    through render's defaults at 1024x1024, 16 spp (regeneration: T1 on
    its 2^21-lane launches); then 2^18 paths of a crop through the
    regeneration loop against the fixed-depth loop, per path."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod
    from rs_pbrt_tpu_torch.models.integrators import regen
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import bvh
    from rs_pbrt_tpu_torch.tools import texture_scenes

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, camera = texture_scenes.statue_marble(STATUE_ENV_RES, STATUE_SUBDIV, device=DEVICE)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    if not torch.equal(scene.tri_attr, statue["scene"].tri_attr):
        fail("statue_marble's triangles differ from phase 9's statue")
    accel = statue["accel"]
    print(f"[24 statue_marble] {scene.n_tris} triangles (phase 9's BVH), texture slots "
          f"{scene.tex_slot_mask:#x}, kinds {scene.tex_kind_mask:#x}; scene built in "
          f"{host_s:.3f} s (host)", flush=True)
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
        fail("the statue_marble render did not take the regeneration loop")
    # T1 twice an iteration: the BSDF's kd and the bump map
    want = expect_counts(sobol=2 * st["batches"], bvh12_closest=st["iterations"],
                         bvh12_any=st["iterations"], texture_eval=2 * st["iterations"])
    if counts != want:
        fail(f"launch counts of the statue_marble render {counts}, expected {want}")
    if int(overflow.item()) or tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
        fail(f"statue_marble: stack overflows {int(overflow.item())}, image shape "
             f"{tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
    print(f"[24 statue_marble] {w}x{h}, {spp} spp, depth {DEPTH}, {paths} paths through "
          f"{st['lane_width']} lanes, {st['iterations']} iterations; launches {counts}; stack "
          f"overflows 0; mean {float(img.mean()):.5f}; {st['paths_per_s']:.6g} camera paths/s "
          f"({st['wall_s']:.3f} s, after a warm render of 1 spp); peak device memory "
          f"{peak / 2**30:.2f} GiB ({(peak - held) / paths:.1f} bytes a path above the scene) "
          f"on {card}", flush=True)
    del img
    prof = profile_render(lambda: go(cfg._replace(spp=STATUE_ENV_PROFILE_SPP)),
                          f"24 profile, {STATUE_ENV_PROFILE_SPP} spp (regeneration)")
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
    if crop_counts != expect_counts(sobol=1, bvh12_closest=n_it, bvh12_any=n_it,
                                    texture_eval=2 * n_it):
        fail(f"launch counts of the statue_marble regeneration check {crop_counts}")
    L_fixed = pathmod.general_radiance(scene, pcfg, scfg, ctx, rays.o, rays.d, accel)
    torch.cuda.synchronize()
    fixed_counts = read_counts()
    path_err = float((L - L_fixed).abs().max())
    if int(overflow.item()) or not torch.isfinite(L).all():
        fail("the statue_marble regeneration check overflowed its stack or is not finite")
    if not torch.allclose(L, L_fixed, rtol=1e-5, atol=1e-6):
        fail(f"statue_marble: the regeneration loop's radiance differs from the fixed-depth "
             f"loop's by up to {path_err}")
    seconds = time.perf_counter() - t_phase
    print(f"[24 regen] {n} paths of a {cw}x{ch} crop through {REGEN_CHECK_WIDTH} lanes: {n_it} "
          f"iterations; every path equals the fixed-depth loop's at rtol 1e-5, atol 1e-6 (max "
          f"abs err {path_err:.3g}, {int(torch.equal(L, L_fixed))} bit-equal); stack overflows 0;"
          f" phase 24 {seconds:.1f} s", flush=True)
    return dict(counts={k: counts[k] + fixed_counts[k] for k in counts},
                paths_per_s=st["paths_per_s"], peak=peak, busy_ms=sum(r[0] for r in prof),
                seconds=seconds)


def h1_bound_ms(index, dim0: int, n_dims: int, exp_x: int, scale_y: int,
                clip: bool = False) -> tuple:
    """Least time of one H1 launch on these inputs, as (bytes_ms,
    operations_ms).  Bytes: each lane's 32-bit index in and 4 bytes a dim
    out, the permutations of the block's bases once.  Operations: H1_OPS a
    (lane, dim) and a digit step, the steps counted from the digits each
    lane's index has in each dim's base (dim 1: index // scale_y in base
    3; dim 0 has none)."""
    import math

    import torch

    from rs_pbrt_tpu_torch.ops import halton_kernel as hk
    from rs_pbrt_tpu_torch.ops import lowdiscrepancy as ld

    dims = hk._dims(dim0, n_dims, clip)
    a = (index.to(torch.int64) & ld.U32_MASK).to(torch.float64)
    digits = 0
    for d in {int(x) for x in dims if x >= 1}:
        base = 3 if d == 1 else int(ld.HALTON_PRIMES[d])
        x = torch.floor(a / scale_y) if d == 1 else a
        k = torch.where(x > 0, torch.floor(torch.log(torch.clamp(x, min=1.0)) / math.log(base))
                        + 1.0, 0.0)
        # exact at the powers of the base, where the logarithm may round
        k = k + (torch.pow(base, k) <= x).double() - ((k > 0) & (torch.pow(base, k - 1) > x)).double()
        digits += int(k.sum()) * int((dims == d).sum())
    scr = dims >= 2
    table = (2 * int((ld.PRIME_SUMS[dims] + ld.HALTON_PRIMES[dims])[scr].max()
                     - ld.PRIME_SUMS[dims][scr].min()) if scr.any() else 0)
    n = index.shape[0]
    nbytes = n * 4 * (1 + n_dims) + table
    ops = n * n_dims * H1_OPS["dim"] + digits * H1_OPS["digit"]
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_FLOP_PER_S


def check_halton(what: str, got, want, args=None) -> tuple:
    """Fails unless an H1 launch's output equals the plain version's bit for
    bit.  (max_abs_err, exact); args (the launch's inputs) unread."""
    import torch

    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        fail(f"{what} differs from its plain version by up to {err}")
    return err, True


def h1_part(timer, tag: str) -> dict:
    """Every recorded H1 launch held bit-equal to its plain version, its
    bound from h1_bound_ms."""
    from rs_pbrt_tpu_torch.ops import halton_kernel as hk

    return kernel_part(timer, tag, "H1", hk.halton_dims_plain, hk.halton_dims, h1_bound_ms,
                       check_halton, lambda *a, **kw: a[0].shape[0])


def merge_parts(parts) -> dict:
    """One part of the launches of several parts."""
    keys = ("ms", "device_ms", "plain_ms", "bound")
    return dict({k: [x for p in parts for x in p[k]] for k in keys},
                max_abs_err=max(p["max_abs_err"] for p in parts),
                exact=all(p["exact"] for p in parts), lanes=sum(p["lanes"] for p in parts))


def sampler_counts(integrator: str, kind: str, n_lights: int, depth: int = DEPTH,
                   iterations: int = 0, accel: bool = False) -> dict:
    """Phase 25's launch counts: the sampler's kernel (K1 for Sobol', H1 for
    Halton, none for the others) once for the camera dims and once a block
    of integrator dims; K5 (B1 through the statue's BVH) a closest hit, K4
    (B2) a shadow ray; S1 once an SPPM iteration."""
    if integrator == "sppm":
        blocks = iterations * (1 + depth)
        sweeps = dict(full_sweep=2 * depth * iterations, any_sweep=depth * iterations,
                      sppm_deposit=iterations)
    elif integrator in ("path", "volpath"):  # every bounce's dims in one block
        blocks = 2
        sweeps = dict(full_sweep=depth + 1, any_sweep=depth + int(integrator == "volpath"))
    else:
        blocks = 1 + depth
        sweeps = dict(full_sweep=depth, any_sweep=depth * n_lights)
    if accel:
        sweeps = dict(bvh12_closest=sweeps.pop("full_sweep"), bvh12_any=sweeps.pop("any_sweep"),
                      **sweeps)
    own = {"sobol": dict(sobol=blocks), "halton": dict(halton=blocks)}.get(kind, {})
    return dict(sweeps, **own)


def phase_samplers(card, statue):
    """Phase 25: H1 on seeded indices; the Cornell box with every sampler
    through path and with Halton through volpath, whitted and
    directlighting, each beside the Sobol' render; caustic_only's SPPM with
    Halton; phase 9's statue with Halton."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import halton_kernel as hk
    from rs_pbrt_tpu_torch.ops import lowdiscrepancy as ld
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.scene import presets
    from rs_pbrt_tpu_torch.tools import caustic_scenes

    t_phase = time.perf_counter()
    kinds = dict(sobol=smpl.SOBOL, halton=smpl.HALTON, zerotwo=smpl.ZEROTWO,
                 stratified=smpl.STRATIFIED, maxmin=smpl.MAXMIN)
    # H1 at the main paths' shapes: a 256-wide film's pixel digits; the
    # host's permutation table is built first, outside the events
    ld.halton_permutations(ld.HALTON_MAX_BASES)
    g = torch.Generator(DEVICE).manual_seed(25)
    cases = LaunchTimer(hk.halton_dims, keep=True)
    for n, dim0, n_dims, clip in H1_CASES:
        idx = torch.randint(-(1 << 31), 1 << 31, (n,), device=DEVICE, generator=g,
                            dtype=torch.int32)  # the u32 indices' bits, as make_ctx holds them
        cases(idx, dim0, n_dims, 7, 243, clip=clip)
    parts = {"cases": h1_part(cases, "25 cases")}
    for (n, dim0, n_dims, clip), t, b in zip(H1_CASES, parts["cases"]["device_ms"],
                                             parts["cases"]["bound"]):
        print(f"[25 H1] {n} lanes, dims {dim0}..{dim0 + n_dims - 1}{' clipped' if clip else ''}:"
              f" bit-equal; {t:.4f} ms on the card (queued), bound {max(b):.4f} ms (bytes "
              f"{b[0]:.4f}, operations {b[1]:.4f}) ({card})", flush=True)
    del cases

    def run(tag, scene, camera, cfg, kind, want, accel=None, no_k2=False, lanes_unit=None,
            **kw):
        """One render with its counts checked, H1's launches recorded; for
        Halton the render with H1's plain version too.  -> (rate, mean,
        counts)."""
        scfg = smpl.make_sampler(kinds[kind], 1 if cfg.integrator == "sppm" else cfg.spp,
                                 camera.resolution)
        go = lambda c=cfg, stats=None: rdr.render(scene, camera, c, scfg, accel=accel,
                                                  stats=stats, **kw)
        rec = LaunchTimer(hk.halton_dims, keep=True)
        st = {}
        with ExitStack() as es:
            if no_k2:
                es.enter_context(mock.patch.object(pk, "mega_cfg", lambda *a, **k: None))
            warm = (cfg._replace(extra=dict(cfg.extra, n_iterations=1))
                    if cfg.integrator == "sppm" else cfg._replace(spp=4))
            go(warm)
            patched(es, halton_dims=rec)
            torch.cuda.synchronize()
            zero_counts()
            img = go(stats=st)
            torch.cuda.synchronize()
            counts = read_counts()
            if counts != expect_counts(**want):
                fail(f"launch counts of the {tag} render {counts}, expected {want}")
            w, h = camera.resolution
            if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
                fail(f"{tag} image: shape {tuple(img.shape)}, finite "
                     f"{bool(torch.isfinite(img).all())}")
            exact = ""
            if kind == "halton":
                patched(es, halton_dims=hk.halton_dims_plain)
                if not torch.equal(go(), img):
                    fail(f"the {tag} image differs from the render with H1's plain version")
                exact = "; equal to the render with H1's plain version"
        if cfg.integrator == "sppm":
            rate = w * h * cfg.extra["n_iterations"] * 2 / st["wall_s"]
        else:
            rate = st["paths_per_s"]
        mean = float(img.mean())
        if rec.calls:
            parts[tag] = h1_part(rec, f"25 {tag}")
        shown = {k: v for k, v in counts.items() if v}
        print(f"[25 {tag}] finite{exact}; mean {mean:.6f}; launches {shown}, as expected; "
              f"{rate:.6g} {lanes_unit or 'camera paths/s'} (one render after a warm one, "
              f"{1e3 * st['wall_s']:.3f} ms) on {card}", flush=True)
        return dict(rate=rate, mean=mean, counts=counts)

    out = {}
    scene, camera = presets.cornell_box(RES, device=DEVICE)
    for integrator in ("path", "volpath", "whitted", "directlighting"):
        cfg = rdr.RenderCfg(integrator, SPP, DEPTH, 1.0)
        for kind in ("sobol",) + (SAMPLER_KINDS if integrator == "path" else ("halton",)):
            tag = f"cornell {integrator} {kind}"
            out[tag] = run(tag, scene, camera, cfg, kind,
                           sampler_counts(integrator, kind, scene.n_lights),
                           no_k2=integrator == "path" and kind == "sobol")
        ref = out[f"cornell {integrator} sobol"]
        print(f"[25 cornell {integrator}] {RES[0]}x{RES[1]}, {SPP} spp, depth {DEPTH}: "
              + "; ".join(f"{k} {out[f'cornell {integrator} {k}']['rate']:.6g} paths/s, mean "
                          f"{out[f'cornell {integrator} {k}']['mean']:.6f}"
                          for k in ("sobol",) + (SAMPLER_KINDS if integrator == "path"
                                                 else ("halton",)))
              + f" (Sobol' on the general bounce, mean {ref['mean']:.6f}; {card})", flush=True)
    del scene, camera
    # SPPM with Halton: the camera pass's sample numbers are iteration numbers
    scene, camera = caustic_scenes.caustic_only(SPPM_RES, device=DEVICE)
    accel = si.build_accel(scene, device=DEVICE)
    cfg = caustic_scenes.CFG._replace(
        extra=dict(caustic_scenes.CFG.extra, n_iterations=SAMPLER_SPPM_ITERATIONS))
    for kind in ("sobol", "halton"):
        tag = f"caustic_only sppm {kind}"
        out[tag] = run(tag, scene, camera, cfg, kind,
                       sampler_counts("sppm", kind, scene.n_lights, cfg.max_depth,
                                      SAMPLER_SPPM_ITERATIONS),
                       accel=accel, lanes_unit="SPPM rays/s (w h iterations 2)")
    del scene, camera, accel
    # phase 9's statue with Halton through the fixed-depth loop
    cfg = rdr.RenderCfg("path", STATUE_SPP, DEPTH, 1.0)
    tag = "statue path halton"
    out[tag] = run(tag, statue["scene"], statue["camera"], cfg, "halton",
                   sampler_counts("path", "halton", statue["scene"].n_lights, accel=True),
                   accel=statue["accel"], regen=False)
    print(f"[25 statue] {STATUE_RES[0]}x{STATUE_RES[1]}, {STATUE_SPP} spp, depth {DEPTH}, the "
          f"fixed-depth loop: Halton {out[tag]['rate']:.6g} camera paths/s beside phase 9's "
          f"Sobol' {statue['paths_per_s']:.6g} (mean {out[tag]['mean']:.6f}; {card})", flush=True)
    renders = {k: v for k, v in parts.items() if k != "cases"}
    h1 = merge_parts(list(renders.values()))
    print_part("H1", "25 renders", h1, card)
    print_part("H1", "25 cases", parts["cases"], card)
    seconds = time.perf_counter() - t_phase
    print(f"[25] {seconds:.1f} s", flush=True)
    return dict(renders=out, h1=h1, cases=parts["cases"], seconds=seconds,
                counts={k: sum(r["counts"][k] for r in out.values())
                        for k in next(iter(out.values()))["counts"]})


def cornell_camera(kind: str, lens=SINGLET):
    """Phase 26's cameras on the Cornell box at RES: the flagship's
    perspective view; the realistic camera (an 8 mm aperture, focused at
    1078, the box's middle, a 35 mm film diagonal); the orthographic camera
    over a 600 x 600 window; the environment camera in the box's middle;
    the perspective view moving to another end over the shutter."""
    from rs_pbrt_tpu_torch.models import cameras as cam
    from rs_pbrt_tpu_torch.utils import transform as tr

    view = tr.look_at(*CORNELL_VIEW)
    if kind == "realistic":
        return cam.make_realistic(view, RES, lens, aperture_diameter=8.0, focus_distance=1078.0,
                                  film_diag_mm=35.0, device=DEVICE)
    if kind == "orthographic":
        return cam.make_orthographic(view, RES, screen_window=(-300.0, 300.0, -300.0, 300.0),
                                     device=DEVICE)
    if kind == "environment":
        return cam.make_environment(tr.look_at((278, 273, 280), (278, 273, 560), (0, 1, 0)), RES,
                                    device=DEVICE)
    end = tr.look_at((310, 290, -770), (268, 276, 0), (0.05, 1, 0)) if kind == "motion" else None
    return cam.make_perspective(view, RES, fov=39.3077, cam_to_world_end=end, device=DEVICE)


def splat_sums(rgb, weight, cfg, p_film, L) -> tuple:
    """Per pixel, the sum of the |terms| a splat adds (with the film's own
    |value|) and their count, for rgb and for the weight: the plain
    version's taps (splat_kernel.taps) with |w L| and |w|."""
    import torch

    from rs_pbrt_tpu_torch.ops import splat_kernel as rk

    h, w = weight.shape
    abs_rgb, abs_w = rgb.abs().reshape(-1, 3).clone(), weight.abs().reshape(-1).clone()
    count = torch.ones(h * w, device=rgb.device)
    L = torch.where(torch.isfinite(L).all(-1)[:, None], L, 0.0).abs()
    for idx, wgt in rk.taps(cfg, p_film, h, w):
        wgt = wgt.abs()
        abs_rgb.index_add_(0, idx, wgt[:, None] * L)
        abs_w.index_add_(0, idx, wgt)
        count.index_add_(0, idx, (wgt != 0).float())
    return abs_rgb.reshape(rgb.shape), abs_w.reshape(weight.shape), count.reshape(weight.shape)


def r1_bound_ms(rgb, weight, cfg, p_film, L, work: dict) -> tuple:
    """Least time of one R1 launch, as (bytes_ms, operations_ms).  Bytes:
    p_film and L in, a lane; the film's rgb and weight read and written
    once.  Operations: R1_OPS a lane, 2F axis factors a lane, and a tap in
    the film with a nonzero weight (counted here; work["atomics"] gains
    its 4 atomic adds)."""
    from rs_pbrt_tpu_torch.ops import film as fm
    from rs_pbrt_tpu_torch.ops import splat_kernel as rk

    h, w = weight.shape
    taps = sum(int((wgt != 0.0).sum()) for _, wgt in rk.taps(cfg, p_film, h, w))
    work["atomics"] = work.get("atomics", 0) + 4 * taps
    n, F = p_film.shape[0], fm.footprint(cfg)
    nbytes = n * R1_LANE_BYTES + weight.numel() * R1_PIXEL_BYTES
    ops = (n * (R1_OPS["lane"] + 2 * F * (R1_OPS["offset"] + R1_OPS["kinds"][cfg.kind]))
           + taps * R1_OPS["tap"])
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_FLOP_PER_S


def check_splat(what: str, got, want, args, worst: dict) -> tuple:
    """Fails unless an R1 launch's film is within 2 n 2^-24 of each pixel's
    summed |terms| (splat_sums of args, the launch's inputs; n terms there:
    two sums of the same terms in any two orders differ by at most that) of
    the plain splat's.  worst["max_rel"] keeps the largest share of that
    limit.  (max_abs_err, exact)."""
    import torch

    abs_rgb, abs_w, count = splat_sums(*args)
    err, exact = 0.0, True
    for g, w, tot, cnt in ((got[0], want[0], abs_rgb, count[..., None]),
                           (got[1], want[1], abs_w, count)):
        diff = (g - w).abs()
        lim = 2.0 * cnt * 2.0 ** -24 * tot
        err = max(err, float(diff.max()))
        worst["max_rel"] = max(worst.get("max_rel", 0.0),
                               float((diff / lim.clamp(min=1e-30)).max()))
        exact = exact and torch.equal(g, w)
        if not bool((diff <= lim).all()):
            fail(f"{what}: a pixel differs from the plain splat by {float(diff.max())}, past "
                 f"2 n 2^-24 of its |terms|")
    return err, exact


def r1_part(timer, tag: str) -> dict:
    """Every R1 launch that timer (LaunchTimer with keep and copy) recorded
    held to the plain splat on copies of the same film (check_splat), its
    bound and atomic adds from r1_bound_ms."""
    from rs_pbrt_tpu_torch.ops import splat_kernel as rk

    worst = dict(max_rel=0.0, atomics=0)
    part = kernel_part(timer, tag, "R1",
                       lambda rgb, w, *a: rk.splat_plain(rgb.clone(), w.clone(), *a), rk.splat,
                       lambda *a: r1_bound_ms(*a, work=worst),
                       lambda what, got, want, a: check_splat(what, got, want, a, worst),
                       lambda *a: a[3].shape[0])
    return part | worst


def l1_bound_ms(camera, p_film, u_lens) -> tuple:
    """Least time of one L1 launch on these inputs, as (bytes_ms,
    operations_ms): L1_LANE_BYTES a lane; L1_OPS a lane and a (lane,
    element) pair the trace reaches (counted by the plain version)."""
    from rs_pbrt_tpu_torch.ops import lens_kernel as lk

    work = {}
    lk.lens_rays_plain(camera, p_film, u_lens, work=work)
    n = p_film.shape[0]
    ops = (n * L1_OPS["lane"] + work.get("sphere", 0) * L1_OPS["sphere"]
           + work.get("stop", 0) * L1_OPS["stop"])
    return 1e3 * n * L1_LANE_BYTES / HBM_BYTES_PER_S, 1e3 * ops / FP32_FLOP_PER_S


def check_lens(what: str, got, want, args=None) -> tuple:
    """Fails unless an L1 launch matches its plain version: the same
    vignetted lanes, o, d and weight bit-equal or within rtol = atol =
    1e-5.  (max_abs_err, exact); args (the launch's inputs) unread."""
    import torch

    if not torch.equal(got[2] > 0, want[2] > 0):
        fail(f"{what}: {int(((got[2] > 0) != (want[2] > 0)).sum())} lanes vignetted in one "
             f"and not in the other")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.allclose(g, w, rtol=1e-5, atol=1e-5) for g, w in zip(got, want)):
        fail(f"{what} differs from its plain version by up to {err}")
    return err, all(torch.equal(g, w) for g, w in zip(got, want))


def l1_part(timer, tag: str) -> dict:
    """Every recorded L1 launch held to its plain version (check_lens)."""
    from rs_pbrt_tpu_torch.ops import lens_kernel as lk

    return kernel_part(timer, tag, "L1", lk.lens_rays_plain, lk.lens_rays, l1_bound_ms,
                       check_lens, lambda *a, **kw: a[1].shape[0])


def phase_cameras(card):
    """Phase 26: the flagship's Cornell box at RES, SPP, DEPTH through the
    other cameras and filters (CAMERA_RUNS), each against its plain render;
    every R1 and L1 launch against its plain version; R1 with every filter
    kind and L1 on a stopped lens with both weightings, on the flagship's
    lanes."""
    import dataclasses

    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import film as fm
    from rs_pbrt_tpu_torch.ops import lens_kernel as lk
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.ops import splat_kernel as rk
    from rs_pbrt_tpu_torch.scene import presets

    t_phase = time.perf_counter()
    scene, flagship = presets.cornell_box(RES, device=DEVICE)
    cfg = rdr.RenderCfg("path", SPP, DEPTH, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, SPP, RES)
    w, h = RES
    out = {}
    r1t = LaunchTimer(rk.splat, keep=True, copy=True)
    l1t = LaunchTimer(lk.lens_rays, keep=True)
    for tag, kind, fkind in CAMERA_RUNS:
        t0 = time.perf_counter()
        camera = flagship if kind == "perspective" else cornell_camera(kind)
        host_s = time.perf_counter() - t0
        fcfg = fm.make_filter(fkind)
        go = lambda stats=None: rdr.render(scene, camera, cfg, scfg, fcfg, stats=stats)
        go()  # warm
        torch.cuda.synchronize()
        zero_counts()
        with ExitStack() as es:
            patched(es, splat=r1t, lens_rays=l1t)
            img = go()
            torch.cuda.synchronize()
        counts = read_counts()
        want = dict(sobol=1, bounce=DEPTH + 1)
        if not fm.grid_filter(fcfg):
            want["splat"] = 1
        if kind == "realistic":
            want["lens"] = 1
        if counts != expect_counts(**want):
            fail(f"launch counts of the {tag} render {counts}, expected {want}")
        if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all() or \
                float(img.mean()) <= 0.0:
            fail(f"{tag} image: shape {tuple(img.shape)}, finite "
                 f"{bool(torch.isfinite(img).all())}, mean {float(img.mean())}")
        with ExitStack() as es:
            patched(es, sobol_dims=sk.sobol_dims_plain, bounce=pk.bounce_plain,
                    splat=rk.splat_plain, lens_rays=lk.lens_rays_plain)
            img_plain = go()
        torch.cuda.synchronize()
        err = compare_plain(f"{tag} image", img, img_plain)
        del img_plain
        st = best_of_3(go)
        prof = profile_render(go, f"26 profile, {tag}", top=6)
        busy = sum(r[0] for r in prof)
        shown = {k: v for k, v in counts.items() if v}
        print(f"[26 {tag}] Cornell {w}x{h}, {SPP} spp, depth {DEPTH}, the {kind} camera "
              f"({host_s:.2f} s to make on the host), filter {fcfg}: finite, matches the plain "
              f"render (max abs err {err:.3g}, mean {float(img.mean()):.5f}); launches {shown}, "
              f"as expected; {st['paths_per_s']:.6g} camera paths/s (best of 3 warm renders, "
              f"{1e3 * st['wall_s']:.3f} ms), device busy {busy:.3f} ms of the profiled "
              f"render on {card}", flush=True)
        out[tag] = dict(counts=counts, rate=st["paths_per_s"], wall_ms=1e3 * st["wall_s"],
                        busy_ms=busy, mean=float(img.mean()))
        if kind == "realistic":
            realistic = camera
        del img
    # the realistic render's lanes (the flagship's film points and lens
    # samples) for the cases below
    (_, (_, p_film, u_lens), _, _), = l1t.calls
    parts = dict(r1=r1_part(r1t, "26 renders"), l1=l1_part(l1t, "26 renders"))
    del r1t, l1t
    print_part("R1", "26 renders", parts["r1"], card, tol="2 n 2^-24 of each pixel's |terms|")
    print_part("L1", "26 renders", parts["l1"], card)
    print(f"[26 R1] renders: {parts['r1']['atomics']} atomic adds in {len(parts['r1']['ms'])} "
          f"launches; the largest pixel error {parts['r1']['max_rel']:.3g} of its limit",
          flush=True)
    # R1 with every filter kind and L1 on a stopped lens, on the flagship's
    # lanes (seeded radiance, a few NaN and infinite lanes)
    g = torch.Generator(DEVICE).manual_seed(26)
    n = p_film.shape[0]
    L = torch.rand((n, 3), device=DEVICE, generator=g) * 2.0
    L[::100003, 1] = float("nan")
    L[7::100003, 0] = float("inf")
    cases = LaunchTimer(rk.splat, keep=True, copy=True)
    for fkind in range(5):
        cases(torch.zeros((h, w, 3), device=DEVICE), torch.zeros((h, w), device=DEVICE),
              fm.make_filter(fkind), p_film, L)
    parts["r1_cases"] = r1_part(cases, "26 cases")
    for fkind, t, b in zip(range(5), parts["r1_cases"]["device_ms"], parts["r1_cases"]["bound"]):
        print(f"[26 R1] {n} lanes, {fm.make_filter(fkind)} ({fm.footprint(fm.make_filter(fkind))}"
              f" taps a side): {t:.4f} ms on the card (queued), bound {max(b):.4f} ms (bytes "
              f"{b[0]:.4f}, operations {b[1]:.4f}) ({card})", flush=True)
    del cases
    print_part("R1", "26 cases", parts["r1_cases"], card, tol="2 n 2^-24 of each pixel's |terms|")
    stopped = cornell_camera("realistic", STOPPED)
    lenses = LaunchTimer(lk.lens_rays, keep=True)
    for cam_ in (stopped, dataclasses.replace(stopped, simple_weighting=False), realistic):
        lenses(cam_, p_film, u_lens)
    parts["l1_cases"] = l1_part(lenses, "26 cases")
    del lenses
    print_part("L1", "26 cases (stopped lens, both weightings; the singlet)", parts["l1_cases"],
               card)
    seconds = time.perf_counter() - t_phase
    print(f"[26] " + "; ".join(f"{t} {out[t]['rate']:.6g}" for t, _, _ in CAMERA_RUNS)
          + f" camera paths/s ({card}); phase 26 {seconds:.1f} s", flush=True)
    return dict(renders=out, seconds=seconds, **parts)


def same_bits(what: str, got, want, *_) -> tuple:
    """Fails unless every field of a walk's output equals the plain
    version's bit for bit (NaN matching NaN); -> (0.0, True), kernel_part's
    (max_abs_err, exact)."""
    import torch

    if torch.is_tensor(got):
        got, want = {"": got}, {"": want}
    elif hasattr(got, "_asdict"):
        got, want = got._asdict(), want._asdict()
    for k in want:
        g, w = got[k], want[k].to(got[k].dtype)
        same = (g == w) | (torch.isnan(g) & torch.isnan(w)) if g.is_floating_point() else g == w
        if not bool(same.all()):
            fail(f"{what} {k}: {int((~same).sum())} lanes differ from the plain version")
    return 0.0, True


class EndsTimer(LaunchTimer):
    """LaunchTimer that keeps the first and the latest call only, so a long
    render holds two launches' rays, not every one's."""

    def __call__(self, *args, **kw):
        out = super().__call__(*args, **kw)
        if len(self.calls) > 2:
            del self.calls[1]
        return out


def by_kind(closest, any_hit):
    """A wrapper's stand-in that sends closest-hit calls to one recorder and
    any-hit calls (any_hit=True) to the other."""
    return lambda *a, **kw: (any_hit if kw.get("any_hit") else closest)(*a, **kw)


def with_work(plain, works: list):
    """plain(*a, **kw, work=wk) as kernel_part's plain version, each call's
    work dict appended to works (its bound reads the latest)."""
    def run(*a, **kw):
        works.append({})
        out = plain(*a, **kw, work=works[-1])
        return out.valid if kw.get("any_hit") and hasattr(out, "valid") else out
    return run


def instance_bound_ms(work, a, kw) -> tuple:
    """I1/I2's least time on a launch's rays: each ray's 28 B in and 20 B
    (I1) or 1 B (I2) out, and every distinct top node, instance (its w2o),
    inner node and triangle that its plain walk visited read once (the
    tables fit in L2, so a second visit need not reach HBM, as B1's rows);
    1/d, a slab test a box, transforms a candidate and a test a triangle
    for each visit."""
    n = a[0].shape[0]
    nodes = int(work["top_nodes"].sum()) + int(work["inner_nodes"].sum())
    cand, tests = int(work["candidates"].sum()), int(work["tests"].sum())
    out = 1 if kw.get("any_hit") else 20
    nbytes = (n * (RAY_BYTES + out) + (work["top_rows"] + work["inner_rows"]) * WALK_NODE_BYTES
              + work["inst_rows"] * W2O_BYTES + work["tri_rows"] * TRI_BYTES)
    f = WALK_FLOP
    flop = n * f["ray"] + 2 * nodes * f["box"] + cand * f["candidate"] + tests * f["tri"]
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def kd_bound_ms(work, a, kw) -> tuple:
    """D1/D2's least time on a launch's rays: 28 B in and 16 B (D1) or 1 B
    (D2) out a ray, and every distinct node (20 B), prim id slot (4 B) and
    triangle (36 B) that its plain walk read, once; 1/d and the world clip
    a ray, 2 a node popped, 65 a leaf triangle tested."""
    n = a[0].shape[0]
    nodes, tests = int(work["nodes"].sum()), int(work["tests"].sum())
    out = 1 if kw.get("any_hit") else 16
    nbytes = (n * (RAY_BYTES + out) + work["node_rows"] * KD_NODE_BYTES
              + work["slot_rows"] * PRIM_ID_BYTES + work["tri_rows"] * TRI_BYTES)
    f = WALK_FLOP
    flop = n * (f["ray"] + 12) + nodes * f["kd_node"] + tests * f["tri"]
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def motion_bound_ms(work, a, kw, set_up: int) -> tuple:
    """V1's least time on a launch's rays, bound by its operations: the
    set-up (set_up operations, tools/op_count.motion_ops) for each live ray
    and group and 65 a ray-triangle test, any hit counted up to each ray's
    first hit (anim_hits_plain's work); bytes: 28 B in, 4 B of time and 21
    B (closest) or 1 B (any) out a ray, the triangles once."""
    o, scene = a[0], a[4]
    n = o.shape[0]
    out = 1 if kw.get("any_hit") else 21
    nbytes = n * (RAY_BYTES + TIME_BYTES + out) + scene.n_anim_tris * TRI_BYTES
    flop = work["setups"] * set_up + work["tests"] * WALK_FLOP["tri"]
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def phase_instances(card):
    """Phase 27: the forest at FOREST_RES, FOREST_SPP through the
    regeneration loop (I1, I2), the moving Cornell box at RES, SPP through
    the general bounce (V1), the kd statue at RES, SPP (D1, D2)."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import instance_kernel as ink
    from rs_pbrt_tpu_torch.ops import instancing as inst
    from rs_pbrt_tpu_torch.ops import kdtree as kd
    from rs_pbrt_tpu_torch.ops import kdtree_kernel as kdk
    from rs_pbrt_tpu_torch.ops import motion_kernel as mok
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.scene import arrays as sa
    from rs_pbrt_tpu_torch.scene import bigscene
    from rs_pbrt_tpu_torch.tools import instance_scenes as isc
    from rs_pbrt_tpu_torch.tools import op_count

    t_phase = time.perf_counter()
    out = {}
    # the forest
    t0 = time.perf_counter()
    scene, camera = isc.forest_scene(FOREST_RES, FOREST_SUBDIV, FOREST_GRID, device=DEVICE)
    t1 = time.perf_counter()
    accel = si.build_accel(scene, device=DEVICE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tables = sum(t.numel() * t.element_size() for t in accel.inst) + (
        scene.proto_attr.numel() * scene.proto_attr.element_size())
    in_view = scene.n_instances * scene.n_proto_tris
    flat = in_view * sa.N_TRI_ATTR * 4
    print(f"[27 forest] {scene.n_instances} instances of {scene.n_proto_tris} triangles "
          f"({in_view} in view): scene {t1 - t0:.2f} s, trees {t2 - t1:.2f} s on the host "
          f"(top {accel.inst.top_box.shape[0]} nodes, prototypes {accel.inst.inner_box.shape[0]}); "
          f"its tables {tables / 2**20:.1f} MiB, the same triangles' rows stored flat "
          f"{flat / 2**20:.1f} MiB before their BVH (phase 12's statue)", flush=True)
    w, h = FOREST_RES
    cfg = rdr.RenderCfg("path", FOREST_SPP, DEPTH, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, FOREST_SPP, FOREST_RES)
    timers = {kid: EndsTimer(ink.instance_intersect, keep=True) for kid in ("I1", "I2")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    st = {}
    with ExitStack() as es:
        patched(es, instance_intersect=by_kind(timers["I1"], timers["I2"]))
        img = rdr.render(scene, camera, cfg, scfg, accel=accel, stats=st)
        torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    it = st["iterations"]
    want = dict(sobol=2 * st["batches"], full_sweep=it, any_sweep=it, instance_closest=it,
                instance_any=it)
    if counts != expect_counts(**want):
        fail(f"launch counts of the forest render {counts}, expected {want}")
    if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all() or float(img.mean()) <= 0:
        fail(f"forest image: shape {tuple(img.shape)}, mean {float(img.mean())}")
    print(f"[27 forest] {w}x{h}, {FOREST_SPP} spp, depth {DEPTH}, regeneration at "
          f"{st['lane_width']} lanes ({it} iterations, {st['batches']} batch): "
          f"{st['paths_per_s']:.6g} camera paths/s ({st['wall_s']:.3f} s, the first and last "
          f"instance launches' rays kept), peak memory {peak / 2**30:.2f} GiB, mean {float(img.mean()):.5f}; launches "
          f"{ {k: v for k, v in counts.items() if v} } ({card})", flush=True)
    out["forest"] = dict(counts=counts, rate=st["paths_per_s"], peak=peak)
    del img
    parts = {}
    for kid in ("I1", "I2"):
        works = parts.setdefault("works", []) if kid == "I1" else []
        parts[kid] = kernel_part(
            timers[kid], "27 forest", kid, with_work(inst.instance_intersect_plain, works),
            ink.instance_intersect, lambda *a, **kw: instance_bound_ms(works[-1], a, kw),
            same_bits, lambda *a, **kw: a[0].shape[0])
        print_part(kid, "27 forest", parts[kid], card)
    first = parts.pop("works")[0]
    live = first["top_nodes"] > 0
    share = float((first["entered"][live] > inst.K_CANDIDATES).float().mean())
    print(f"[27 forest] the cap: {100 * share:.3f}% of the {int(live.sum())} camera rays of the "
          f"first launch enter more than K_CANDIDATES = {inst.K_CANDIDATES} instance boxes (at "
          f"most {int(first['entered'].max())}); the walk keeps the nearest "
          f"{inst.K_CANDIDATES}, as the JAX package does", flush=True)
    del timers
    pcfg = rdr.RenderCfg("path", FOREST_PROFILE_SPP, DEPTH, 1.0)
    pscfg = smpl.make_sampler(smpl.SOBOL, FOREST_PROFILE_SPP, FOREST_RES)
    prof = profile_render(lambda: rdr.render(scene, camera, pcfg, pscfg, accel=accel),
                          f"27 profile, forest at {FOREST_PROFILE_SPP} spp", top=6)
    out["forest"]["busy_ms"] = sum(r[0] for r in prof)
    out["forest"].update(cap_share=share, **{k: parts[k] for k in ("I1", "I2")})
    del scene, camera, accel
    torch.cuda.empty_cache()

    # the moving Cornell box: the general bounce, V1 at each path's time
    scene, camera = isc.moving_scene(RES, device=DEVICE)
    if pk.mega_cfg(scene) is not None:
        fail("mega_cfg takes the moving box: K2 would drop its moving mesh")
    cfg = rdr.RenderCfg("path", SPP, DEPTH, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, SPP, RES)
    go = lambda stats=None: rdr.render(scene, camera, cfg, scfg, stats=stats)
    go()  # warm
    vtimer = LaunchTimer(mok.anim_hits, keep=True)  # both kinds, every launch
    torch.cuda.synchronize()
    zero_counts()
    with ExitStack() as es:
        patched(es, anim_hits=vtimer)
        img = go()
        torch.cuda.synchronize()
    counts = read_counts()
    want = dict(sobol=2, full_sweep=DEPTH + 1, any_sweep=DEPTH, motion_closest=DEPTH + 1,
                motion_any=DEPTH)
    if counts != expect_counts(**want):
        fail(f"launch counts of the moving render {counts}, expected {want}")
    if not torch.isfinite(img).all() or float(img.mean()) <= 0:
        fail(f"moving image: mean {float(img.mean())}")
    st = best_of_3(go)
    print(f"[27 moving] Cornell {RES[0]}x{RES[1]}, {SPP} spp, depth {DEPTH}, shutter 0-1, "
          f"{scene.n_anim_tris} moving triangles: the general bounce (mega_cfg None, K2 launched "
          f"{counts['bounce']} times); launches { {k: v for k, v in counts.items() if v} }; "
          f"{st['paths_per_s']:.6g} camera paths/s (best of 3 warm renders, "
          f"{1e3 * st['wall_s']:.3f} ms), mean {float(img.mean()):.5f} ({card})", flush=True)
    set_up = op_count.motion_ops()
    works = []
    parts = {"V1": kernel_part(
        vtimer, "27 moving", "V1", with_work(mok.anim_hits_plain, works), mok.anim_hits,
        lambda *a, **kw: motion_bound_ms(works[-1], a, kw, set_up), same_bits,
        lambda *a, **kw: a[0].shape[0])}
    print_part("V1", "27 moving", parts["V1"], card)
    out["moving"] = dict(counts=counts, rate=st["paths_per_s"], V1=parts["V1"], set_up=set_up)
    del vtimer, scene, img
    torch.cuda.empty_cache()

    # the kd statue
    scene, camera = bigscene.statue_scene(RES, KD_SUBDIV, device=DEVICE)
    t0 = time.perf_counter()
    accel = si.build_accel(scene, kind="kdtree", device=DEVICE)
    torch.cuda.synchronize()
    kd_s = time.perf_counter() - t0
    kt = accel.kd
    n_leaf = int((kt.axis == kd.LEAF).sum())
    print(f"[27 kd] statue, {scene.n_tris} triangles: kd build {kd_s:.3f} s on the host, "
          f"{kt.axis.shape[0]} nodes ({n_leaf} leaves), leaf cap {kt.leaf_cap}", flush=True)
    cfg = rdr.RenderCfg("path", SPP, DEPTH, 1.0, accelerator="kdtree")
    scfg = smpl.make_sampler(smpl.SOBOL, SPP, RES)
    timers = {kid: LaunchTimer(kdk.kd_intersect, keep=True) for kid in ("D1", "D2")}
    ovf = kdk.overflow_counter(DEVICE)
    ovf.zero_()
    torch.cuda.synchronize()
    zero_counts()
    st = {}
    with ExitStack() as es:
        patched(es, kd_intersect=by_kind(timers["D1"], timers["D2"]))
        img = rdr.render(scene, camera, cfg, scfg, accel=accel, stats=st)
        torch.cuda.synchronize()
    counts = read_counts()
    it = st["iterations"]
    want = dict(sobol=2 * st["batches"], kd_closest=it, kd_any=it)
    if counts != expect_counts(**want):
        fail(f"launch counts of the kd render {counts}, expected {want}")
    if int(ovf.item()) != 0:
        fail(f"the kd walk dropped {int(ovf.item())} stack entries")
    bvh_accel = si.build_accel(scene, device=DEVICE)
    img_b = rdr.render(scene, camera, rdr.RenderCfg("path", SPP, DEPTH, 1.0), scfg, accel=bvh_accel)
    err = compare_plain("kd image against the BVH's", img, img_b)
    print(f"[27 kd] {RES[0]}x{RES[1]}, {SPP} spp, depth {DEPTH} through the kd-tree: "
          f"{st['paths_per_s']:.6g} camera paths/s ({it} iterations), stack overflows "
          f"{int(ovf.item())}; the image within {err:.3g} of the render through the BVH (B1/B2); "
          f"launches { {k: v for k, v in counts.items() if v} } ({card})", flush=True)
    del img_b, bvh_accel

    for kid in ("D1", "D2"):
        works = []
        parts[kid] = kernel_part(
            timers[kid], "27 kd", kid, with_work(kd.kdtree_intersect_plain, works),
            kdk.kd_intersect, lambda *a, **kw: kd_bound_ms(works[-1], a, kw), same_bits,
            lambda *a, **kw: a[0].shape[0])
        print_part(kid, "27 kd", parts[kid], card)
        if any(wk["overflow"] for wk in works):
            fail(f"the plain kd walk overflowed its stack on a {kid} launch")
    del timers
    out["kd"] = dict(counts=counts, rate=st["paths_per_s"], build_s=kd_s,
                     nodes=kt.axis.shape[0], leaf_cap=kt.leaf_cap, D1=parts["D1"],
                     D2=parts["D2"])
    seconds = time.perf_counter() - t_phase
    f, m, k = out["forest"], out["moving"], out["kd"]
    print(f"[27] forest {f['rate']:.6g}, moving {m['rate']:.6g}, kd statue {k['rate']:.6g} camera "
          f"paths/s; the cap's share {100 * f['cap_share']:.3f}%; kd build {k['build_s']:.2f} s "
          f"({card}); phase 27 {seconds:.1f} s", flush=True)
    return dict(out, seconds=seconds)


def bdpt_strategies(depth: int) -> list:
    """The (s, t) strategies a BDPT evaluation connects at depth."""
    return [(s, t) for t in range(1, depth + 3) for s in range(depth + 2)
            if 0 <= s + t - 2 <= depth and (s, t) != (1, 1)]


def bdpt_counts(depth: int, evaluations: int, sobol_batches: int = 0, grid: bool = False,
                sky: bool = False) -> dict:
    """Phase 28's launch counts of `evaluations` BDPT evaluations at depth:
    K5 a walk vertex (depth + 1 camera, depth light), K4 a strategy with a
    shadow ray (s > 0), W1 a strategy (and a second for each s = 0 one with
    a sky); K1 twice a batch (the camera's dims and one block of the rest);
    with a grid, M1 as K5 and M2 as K4."""
    strategies = bdpt_strategies(depth)
    walks, shadow = 2 * depth + 1, sum(1 for s, _ in strategies if s > 0)
    mis = len(strategies) + (depth + 1 if sky else 0)
    out = dict(full_sweep=walks * evaluations, any_sweep=shadow * evaluations,
               mis=mis * evaluations)
    if sobol_batches:
        out["sobol"] = 2 * sobol_batches
    if grid:
        out.update(delta_track=walks * evaluations, ratio_track=shadow * evaluations)
    return out


def mis_bound_ms(*a, **kw) -> tuple:
    """W1's least time on a launch's lanes, (bytes_ms, operations_ms): each
    lane reads the 9 bytes (pdf_fwd, pdf_rev, delta) of each of the t - 1 +
    s vertices its walk visits, an override in place of its column, the
    light origin's delta test where s > 0, and writes 4; 3 operations a
    vertex and 2 a lane (s + t = 2: 4 bytes out, nothing read)."""
    c_fwd, s, t = a[0], a[6], a[7]
    l0 = a[9] if len(a) > 9 else kw.get("l0_is_delta")
    n = c_fwd.shape[1]
    if s + t == 2:
        return 1e3 * n * MIS_OUT_BYTES / HBM_BYTES_PER_S, 0.0
    verts = t - 1 + s
    per_lane = verts * MIS_VERTEX_BYTES + (1 if l0 is not None and s > 0 else 0) + MIS_OUT_BYTES
    flop = n * (verts * MIS_OPS_PER_VERTEX + MIS_OPS_PER_LANE)
    return 1e3 * n * per_lane / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S


def check_mis_launches(tag: str, timer) -> int:
    """Holds every W1 launch timer recorded bit-equal to its plain version;
    returns the launches checked."""
    from rs_pbrt_tpu_torch.ops import mis_kernel as wk

    for b, (_, a, kw, o) in enumerate(timer.calls):
        same_bits(f"{tag} W1 launch {b}", o, wk.mis_weight_plain(*a, **kw))
    return len(timer.calls)


def check_medium_launches(tag: str, rec: dict):
    """Holds every recorded M1 and M2 launch to its plain version (as phase
    18 does); returns {key: (launches, bit-equal)}."""
    from rs_pbrt_tpu_torch.ops import medium_kernel as mk

    out = {}
    for key, kid in (("delta_track", "M1"), ("ratio_track", "M2")):
        exact = True
        for b, (_, a, kw, o) in enumerate(rec[key].calls):
            exact &= check_medium(f"{tag} {kid} launch {b}", o,
                                  getattr(mk, f"{key}_plain")(*a, **kw))[1]
        out[key] = (len(rec[key].calls), exact)
    return out


def phase_bidirectional(card):
    """Phase 28: BDPT on the Cornell box at RES, SPP, DEPTH; MLT there at
    MLT_MPP mutations per pixel of MLT_CHAINS chains from MLT_BOOTSTRAP
    bootstrap samples; BDPT on phase 18's smoke at SMOKE_BDPT_RES,
    SMOKE_BDPT_SPP, SMOKE_BDPT_DEPTH; each through render.render, its
    launches counted and held to their plain versions (the Cornell box's
    K4 and K5 on their first and last launch, W1 and the smoke's kernels
    on every one), its image to its plain render."""
    import torch

    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import mlt as mltmod
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import mis_kernel as wk
    from rs_pbrt_tpu_torch.scene import presets
    from rs_pbrt_tpu_torch.tools import sss_scenes

    t_phase = time.perf_counter()
    out, laps = {}, {}

    def recorded(go, recorders, expect, tag, stats=None):
        """go(stats) with the wrappers recorded and the counters zeroed just
        before and read just after: (image, counts)."""
        with ExitStack() as es:
            patched(es, **recorders)
            torch.cuda.synchronize()
            zero_counts()
            img = go(stats)
            torch.cuda.synchronize()
            counts = read_counts()
        if counts != expect_counts(**expect):
            fail(f"launch counts of the {tag} render {counts}, expected {expect}")
        if not torch.isfinite(img).all() or float(img.mean()) <= 0.0:
            fail(f"{tag} image: finite {bool(torch.isfinite(img).all())}, mean "
                 f"{float(img.mean())}")
        return img, counts

    def plain_render(go, tag, img):
        with ExitStack() as es:
            patched(es, **plain_fns(), mis_weight=wk.mis_weight_plain)
            img_plain = go()
        torch.cuda.synchronize()
        return compare_plain(f"{tag} image", img, img_plain)

    def shown(counts):
        return {k: v for k, v in counts.items() if v}

    # BDPT on the flagship's Cornell box, one batch
    scene, camera = presets.cornell_box(RES, device=DEVICE)
    cfg = rdr.RenderCfg("bdpt", SPP, DEPTH, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, SPP, RES)
    w, h = RES
    lanes = w * h * SPP
    go = lambda stats=None: rdr.render(scene, camera, cfg, scfg, stats=stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    go()  # warm, and the peak a lane holds
    torch.cuda.synchronize()
    lane_bytes = (torch.cuda.max_memory_allocated() - base) / lanes
    rec = {k: EndsTimer(wrapper(k), keep=True) for k in SWEEP_NAMES}
    rec["mis_weight"] = LaunchTimer(wk.mis_weight, keep=True)
    img, counts = recorded(go, rec, bdpt_counts(DEPTH, 1, sobol_batches=1), "28 bdpt")
    held = check_sweep_launches("28 bdpt", rec)
    w1 = kernel_part(rec["mis_weight"], "28 bdpt", "W1", wk.mis_weight_plain, wk.mis_weight,
                     mis_bound_ms, same_bits, lambda *a, **kw: a[0].shape[1])
    w1_held = len(rec["mis_weight"].calls)
    del rec
    err = plain_render(go, "28 bdpt", img)
    st = best_of_3(go)
    prof = profile_render(go, "28 profile, bdpt", top=8)
    busy = sum(r[0] for r in prof)
    print(f"[28 bdpt] Cornell {w}x{h}, {SPP} spp, depth {DEPTH}, one batch of {lanes} paths: "
          f"finite, matches the plain render (max abs err {err:.3g}, mean {float(img.mean()):.5f})"
          f"; launches {shown(counts)}, as expected; K1 bit-equal, K4 equal and K5 within "
          f"{TOL} (max abs err {held['full_sweep']['max_abs_err']:.3g}) on their first and last "
          f"launch, W1 on every one; "
          f"{st['paths_per_s']:.6g} camera paths/s (best of 3 warm renders, "
          f"{1e3 * st['wall_s']:.3f} ms), device busy {busy:.3f} ms of the profiled render "
          f"({100 * busy / (1e3 * st['wall_s']):.1f}% of a best render's wall); "
          f"{lane_bytes:.1f} bytes a lane at the render's peak ({card})", flush=True)
    print_part("W1", "28 bdpt", w1, card)
    out["bdpt"] = dict(counts=counts, paths_per_s=st["paths_per_s"], busy_ms=busy,
                       wall_ms=1e3 * st["wall_s"], lane_bytes=lane_bytes)
    del img
    laps["bdpt"] = time.perf_counter() - t_phase

    # MLT there: the bootstrap, the chains' starts, then the mutations; the
    # recorded render is the timed one
    mcfg = rdr.RenderCfg("mlt", 1, DEPTH, 1.0, extra=dict(
        mutations_per_pixel=MLT_MPP, chains=MLT_CHAINS, bootstrap_samples=MLT_BOOTSTRAP))
    go_mlt = lambda stats=None: rdr.render(scene, camera, mcfg, scfg, stats=stats)
    n_mut = max(1, w * h * MLT_MPP // MLT_CHAINS)
    evals = -(-MLT_BOOTSTRAP // mltmod.BOOTSTRAP_CHUNK) + 1 + n_mut
    rec = {k: EndsTimer(wrapper(k), keep=True) for k in SWEEP_NAMES}
    rec["mis_weight"] = LaunchTimer(wk.mis_weight, keep=True)
    st_m = {}
    img, counts_m = recorded(go_mlt, rec, bdpt_counts(DEPTH, evals), "28 mlt", st_m)
    held_m = check_sweep_launches("28 mlt", rec)
    w1_held += check_mis_launches("28 mlt", rec["mis_weight"])
    del rec
    err_m = plain_render(go_mlt, "28 mlt", img)
    print(f"[28 mlt] Cornell {w}x{h}, depth {DEPTH}, {MLT_MPP} mutations a pixel: {MLT_CHAINS} "
          f"chains x {n_mut} mutations from {MLT_BOOTSTRAP} bootstrap samples ({evals} BDPT "
          f"evaluations): finite, matches the plain render from the same generator seed (max "
          f"abs err {err_m:.3g}, mean {float(img.mean()):.5f}); launches {shown(counts_m)}, as "
          f"expected; K4 and K5 held on their first and last launch (K5 max abs err "
          f"{held_m['full_sweep']['max_abs_err']:.3g}), W1 on every one; "
          f"{st_m['mutations_per_s']:.6g} "
          f"mutations/s, {st_m['paths_per_s']:.6g} camera paths/s (the recorded render, "
          f"{st_m['wall_s']:.3f} s) ({card})", flush=True)
    out["mlt"] = dict(counts=counts_m, mutations_per_s=st_m["mutations_per_s"],
                      paths_per_s=st_m["paths_per_s"], wall_s=st_m["wall_s"])
    del img
    laps["mlt"] = time.perf_counter() - t_phase - laps["bdpt"]

    # BDPT on phase 18's smoke: M1 in the walks, M2 in the connections
    smoke, smoke_cam = sss_scenes.smoke_dragonette(SMOKE_GRID_RES, resolution=SMOKE_BDPT_RES,
                                                   device=DEVICE)
    scfg_s = smpl.make_sampler(smpl.SOBOL, SMOKE_BDPT_SPP, SMOKE_BDPT_RES)
    cfg_s = rdr.RenderCfg("bdpt", SMOKE_BDPT_SPP, SMOKE_BDPT_DEPTH, 1.0)
    go_s = lambda stats=None: rdr.render(smoke, smoke_cam, cfg_s, scfg_s, stats=stats)
    go_s()  # warm
    keys = SWEEP_NAMES + ("mis_weight", "delta_track", "ratio_track")
    rec = {k: LaunchTimer(wrapper(k), keep=True) for k in keys}
    img, counts_s = recorded(go_s, rec, bdpt_counts(
        SMOKE_BDPT_DEPTH, 1, sobol_batches=1, grid=True, sky=smoke.has_env), "28 smoke")
    check_sweep_launches("28 smoke", rec)
    w1_held += check_mis_launches("28 smoke", rec["mis_weight"])
    med = check_medium_launches("28 smoke", rec)
    del rec
    err_s = plain_render(go_s, "28 smoke", img)
    st_s = best_of_3(go_s)
    sw, sh = SMOKE_BDPT_RES
    print(f"[28 smoke] smoke_dragonette {sw}x{sh}, a {SMOKE_GRID_RES}^3 grid, bdpt, "
          f"{SMOKE_BDPT_SPP} spp, depth {SMOKE_BDPT_DEPTH}: finite, matches the plain render (max "
          f"abs err {err_s:.3g}, mean {float(img.mean()):.5f}); launches {shown(counts_s)}, as "
          f"expected; every K1, K4, K5 and W1 launch held; M1 "
          f"{'bit-equal' if med['delta_track'][1] else 'within 1e-5'} on {med['delta_track'][0]}"
          f" launches, M2 {'bit-equal' if med['ratio_track'][1] else 'within 1e-5'} on "
          f"{med['ratio_track'][0]}; {st_s['paths_per_s']:.6g} camera paths/s (best of 3 warm "
          f"renders) ({card})", flush=True)
    out["smoke"] = dict(counts=counts_s, paths_per_s=st_s["paths_per_s"])
    del img
    seconds = time.perf_counter() - t_phase
    laps["smoke"] = seconds - laps["bdpt"] - laps["mlt"]
    print(f"[28 W1] {w1_held} launches held bit-equal to the plain version in the three "
          f"renders; BDPT {st['paths_per_s']:.6g} paths/s, MLT {st_m['mutations_per_s']:.6g} "
          f"mutations/s, smoke {st_s['paths_per_s']:.6g} paths/s ({card}); phase 28 "
          f"{seconds:.1f} s (bdpt {laps['bdpt']:.1f}, mlt {laps['mlt']:.1f}, smoke "
          f"{laps['smoke']:.1f})", flush=True)
    return dict(out, w1=w1, w1_held=w1_held, seconds=seconds)


def g1_bound_ms(o, d, tri, g_t, g_b0, g_b1, tris, want_verts=False) -> tuple:
    """Least time of one G1 launch, as (bytes_ms, operations_ms).  Bytes:
    each lane's o, d, tri and three upstream gradients in and g_o, g_d out;
    the vertices of each distinct hit triangle read once, and with
    want_verts the vertex gradients (T, 9) written once.  Operations:
    G1_OPS a lane with a triangle."""
    import torch

    valid = tri >= 0
    distinct = int(torch.unique(tri[valid]).numel())
    nbytes = (o.shape[0] * G1_LANE_BYTES + distinct * VERT_BYTES
              + (tris.shape[0] * VERT_BYTES if want_verts else 0))
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * int(valid.sum()) * G1_OPS / FP32_FLOP_PER_S


def check_g1(what: str, got, want, args) -> tuple:
    """Fails unless a G1 launch's per-lane g_o and g_d equal its plain
    version's or lie within rtol = atol = 1e-5 (exact says which), and,
    with the vertices' gradient, each atomically summed entry lies within
    2 n 2^-24 of its n summed |terms| (the plain version counts them on the
    same inputs).  (max_abs_err of g_o and g_d, exact)."""
    from rs_pbrt_tpu_torch.ops import hit_grad_kernel as hg

    err, exact = check_fourier(what, got[:2], want[:2])
    if got[2] is not None:
        work = {}
        hg.hit_vjp_plain(*args, want_verts=True, work=work)
        diff = (got[2] - want[2]).abs()
        lim = 2.0 * work["n_verts"][:, None] * 2.0 ** -24 * work["abs_verts"]
        if not bool((diff <= lim).all()):
            fail(f"{what}: a vertex gradient differs from the plain version's by "
                 f"{float(diff.max())}, past 2 n 2^-24 of its |terms|")
    return err, exact


def t2_bound_ms(tb, ids, uv, p, width, g_out) -> tuple:
    """Least time of one T2 launch, as (bytes_ms, operations_ms): T1's
    bound on the same lanes (texture_bound_ms: an upstream gradient in for
    the rgb out, the points, texels and tables read) with the gradient
    tables (tex_params, tex_atlas) written once; twice T1's operations,
    the lookup again and its reverse sweep."""
    b, o = texture_bound_ms(tb, texture_work(tb, ids if ids.dim() == 2 else ids[None], uv,
                                             width))
    out = (tb.params.numel() + tb.atlas.numel()) * 4
    return b + 1e3 * out / HBM_BYTES_PER_S, 2.0 * o


def check_t2(what: str, got, want, args=None, worst: dict = None) -> tuple:
    """Fails unless each entry of a backward launch's outputs is finite and
    lies within 1e-3 of the plain version's plus 1e-5 of the output's
    largest |entry|: T2's tex_params and tex_atlas gradients (sums of up to
    a launch's lanes' terms an entry at the pyramid's top levels, added by
    atomics in no fixed order), and T3's, C5's and M3's per-lane gradients
    (their twins compute the kernels' sweeps term by term; a term that
    cancels ~100x its sum carries the last bits of a sin, cos, log2 or
    division that torch and the kernel round apart).  A None output (T3's
    width gradient without a width) is skipped.  worst["t2_rel"] keeps the
    largest share of that limit.  (max_abs_err, exact)."""
    import torch

    err, exact = 0.0, True
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if not bool(torch.isfinite(g).all()):
            fail(f"{what}: a gradient is not finite")
        diff = (g - w).abs()
        lim = 1e-3 * w.abs() + 1e-5 * (float(w.abs().max()) if w.numel() else 0.0)
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        exact = exact and torch.equal(g, w)
        if worst is not None and diff.numel():
            worst["t2_rel"] = max(worst.get("t2_rel", 0.0),
                                  float((diff / lim.clamp(min=1e-30)).max()))
        if not bool((diff <= lim).all()):
            fail(f"{what} differs from its plain version by up to {float(diff.max())}")
    return err, exact


def r2_bound_ms(cfg, p_film, L, g_rgb) -> tuple:
    """Least time of one R2 launch, as (bytes_ms, operations_ms).  Bytes:
    each lane's p_film and L in and g_L out; the film's gradient read once.
    Operations: R1's lane and factor work and R2_TAP_OPS a tap in the film
    with a nonzero weight (counted here)."""
    from rs_pbrt_tpu_torch.ops import film as fm
    from rs_pbrt_tpu_torch.ops import splat_kernel as rk

    h, w = g_rgb.shape[:2]
    taps = sum(int((wgt != 0.0).sum()) for _, wgt in rk.taps(cfg, p_film, h, w))
    n, F = p_film.shape[0], fm.footprint(cfg)
    nbytes = n * R2_LANE_BYTES + g_rgb.numel() * 4
    ops = (n * (R1_OPS["lane"] + 2 * F * (R1_OPS["offset"] + R1_OPS["kinds"][cfg.kind]))
           + taps * R2_TAP_OPS)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_FLOP_PER_S


def phase_gradients(card):
    """Phase 29: gradients and checkpoints (diff/grad.py, diff/geometry.py,
    render's checkpoints) on the card.  Each gradient render's counters
    are zeroed just before it and read just after; each gradient is held to
    the same gradient with every wrapper swapped for its plain version at
    rtol = atol = TOL x its largest |entry|, and every G1, T2 and R2 launch
    to its plain twin."""
    import dataclasses
    import tempfile

    import torch

    from rs_pbrt_tpu_torch.diff import geometry as geo
    from rs_pbrt_tpu_torch.diff import grad as dg
    from rs_pbrt_tpu_torch.models import cameras as cam
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import film as fm
    from rs_pbrt_tpu_torch.ops import hit_grad_kernel as hg
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.ops import splat_kernel as rk
    from rs_pbrt_tpu_torch.ops import texture as tx
    from rs_pbrt_tpu_torch.ops import texture_kernel as tk
    from rs_pbrt_tpu_torch.scene import arrays as sa
    from rs_pbrt_tpu_torch.scene import presets
    from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
    from rs_pbrt_tpu_torch.tools import texture_scenes as ts
    from rs_pbrt_tpu_torch.utils import transform as tr

    t_phase = time.perf_counter()
    mean = lambda img: img.mean()
    out, laps = {}, {}
    w, h = GRAD_RES
    lanes = w * h * GRAD_SPP
    scene, camera = presets.cornell_box(GRAD_RES, device=DEVICE)
    scfg = smpl.make_sampler(smpl.SOBOL, GRAD_SPP, GRAD_RES)
    cfg = rdr.RenderCfg("path", GRAD_SPP, GRAD_DEPTH, 1.0)

    def counted(go, recorders, expect, tag):
        """go() with the wrappers recorded, the counters zeroed just before
        and read just after: (go's result, counts)."""
        with ExitStack() as es:
            patched(es, **recorders)
            torch.cuda.synchronize()
            zero_counts()
            res = go()
            torch.cuda.synchronize()
            counts = read_counts()
        if counts != expect_counts(**expect):
            fail(f"launch counts of the {tag} gradient render {counts}, expected {expect}")
        return res, counts

    def plain_grad(go):
        with ExitStack() as es:
            patched(es, **plain_fns(), closest_sweep=ik.closest_sweep_plain,
                    hit_vjp=hg.hit_vjp_plain, texture_grad=tk.texture_grad_plain,
                    splat=rk.splat_plain, splat_grad=rk.splat_grad_plain)
            res = go()
        torch.cuda.synchronize()
        return res

    def grads_close(what, got, want) -> float:
        err = 0.0
        for name, a, b in zip(got._fields, got, want):
            tol = TOL * float(b.abs().max())
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
            if not bool(torch.isfinite(a).all()) or not torch.allclose(a, b, rtol=TOL, atol=tol):
                fail(f"{what}: d loss / d {name} differs from the plain gradient by up to "
                     f"{float((a - b).abs().max())} (tolerance {TOL} x {float(b.abs().max())})")
        return err

    def shown(counts):
        return {k: v for k, v in counts.items() if v}

    def timed_best(go, reps=3):
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    # 29.1 the main gradient render: grad_loss(mean) over DiffParams
    go_g = lambda: dg.grad_loss(scene, camera, cfg, scfg, mean)
    go_g()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = {k: EndsTimer(wrapper(k), keep=True) for k in SWEEP_NAMES}
    (loss, g), counts = counted(go_g, rec, dict(sobol=2, full_sweep=GRAD_DEPTH + 1,
                                                any_sweep=GRAD_DEPTH), "29 grad")
    peak = torch.cuda.max_memory_allocated() - base
    with torch.no_grad():
        held = check_sweep_launches("29 grad", rec)
    del rec
    err = grads_close("29 grad", g, plain_grad(go_g)[1])
    p0 = dg.get_params(scene)

    def fd(render, leaf, index, step):
        vals = []
        for sgn in (1.0, -1.0):
            arr = getattr(p0, leaf).clone()
            arr[index] += sgn * step
            with torch.no_grad():
                vals.append(float(mean(render(p0._replace(**{leaf: arr})))))
        return (vals[0] - vals[1]) / (2 * step)

    kd_idx = (1, sa.MP_KD)  # the white walls' kd red
    ad_kd = float(g.mat_params[kd_idx])
    fd_kd = fd(lambda p: dg.render_image(scene, camera, cfg, scfg, p), "mat_params", kd_idx, 5e-3)
    if not (ad_kd > 0.0 and abs(ad_kd - fd_kd) <= FD_RTOL * abs(fd_kd)):
        fail(f"29 grad: d loss / d kd red {ad_kd} against its central difference {fd_kd}")
    best = timed_best(go_g)
    prof = profile_render(go_g, "29 profile, grad", top=8)
    busy = sum(r[0] for r in prof)
    print(f"[29 grad] Cornell {w}x{h}, {GRAD_SPP} spp, depth {GRAD_DEPTH} ({lanes} paths), "
          f"grad_loss(mean) over DiffParams: loss {float(loss):.6f}; launches {shown(counts)} "
          f"(K2 0: refused under a gradient); K1 bit-equal, K4 equal, K5 within {TOL} on their "
          f"first and last launch; the gradient within rtol = atol = {TOL} x max|g| of the "
          f"plain gradient (max abs err {err:.3g}); white kd red {ad_kd:.6g} against its "
          f"central difference {fd_kd:.6g} (rtol {FD_RTOL}); forward and backward "
          f"{lanes / best:.6g} paths/s (best of 3, {1e3 * best:.3f} ms), peak {peak / 2**20:.1f} "
          f"MiB ({peak / lanes:.1f} bytes a lane), device busy {busy:.3f} ms of the profiled "
          f"gradient render ({card})", flush=True)
    out["grad"] = dict(counts=counts, paths_per_s=lanes / best, wall_ms=1e3 * best,
                       busy_ms=busy, peak_bytes=peak, lane_bytes=peak / lanes, ad=ad_kd,
                       fd=fd_kd, ref=(loss, g))
    del g
    laps["grad"] = time.perf_counter() - t_phase

    # 29.2 the camera gradient: K3 on detached rays, G1 its backward
    ccfg = cfg._replace(max_depth=GRAD_CAM_DEPTH)
    go_c = lambda: dg.grad_loss_wrt_camera(scene, camera, ccfg, scfg, mean)
    go_c()  # warm
    g1t = LaunchTimer(hg.hit_vjp, keep=True)
    k3t = EndsTimer(ik.closest_sweep, keep=True)
    (loss_c, gc), counts_c = counted(
        go_c, dict(hit_vjp=g1t, closest_sweep=k3t),
        dict(sobol=2, closest_sweep=GRAD_CAM_DEPTH + 1, any_sweep=GRAD_CAM_DEPTH,
             hit_grad=GRAD_CAM_DEPTH), "29 camera")
    with torch.no_grad():
        for b, (_, a, kw, o) in enumerate(k3t.calls):
            check_isect(f"29 camera K3 launch {b}", "closest", o,
                        ik.closest_sweep_plain(*a, **kw))
    del k3t
    err_c = grads_close("29 camera", gc, plain_grad(go_c)[1])
    # the central differences over the pixels whose samples keep their
    # visibility: each closest hit's triangle (the camera ray's and every
    # bounce's, so every light hit) and each shadow ray's occlusion the same
    # in the base render and in the four stepped ones.  A sample whose
    # visibility changes carries a boundary term (a silhouette crossing
    # it), which detached sampling leaves out: its pixel is left out of the
    # loss on both sides
    def seen(cm):
        """The image of a camera gradient render through cm and its
        visibility: each K3 launch's triangles and each K4 launch's bits."""
        sig, img = [], []

        def keep(fn, pick):
            def run(*a, **kw):
                res = fn(*a, **kw)
                sig.append(pick(res).clone())
                return res
            return run

        with ExitStack() as es:
            patched(es, closest_sweep=keep(ik.closest_sweep, lambda r: r.tri),
                    any_sweep=keep(ik.any_sweep, lambda r: r))
            dg.grad_loss_wrt_camera(scene, cm, ccfg, scfg,
                                    lambda im: img.append(im.detach()) or im.mean())
        return img[0].double(), sig

    def stepped(k, sgn):
        m = camera.cam_to_world.clone()
        m[k, 3] += sgn * CAM_FD_STEP
        return dataclasses.replace(camera, cam_to_world=m)

    _, sig0 = seen(camera)
    unstable = torch.zeros(w * h, dtype=torch.bool, device=DEVICE)
    imgs, moved = {}, {}
    for k in (1, 2):
        for sgn in (1.0, -1.0):
            imgs[k, sgn], sig = seen(stepped(k, sgn))
            if any(x.shape != (lanes,) for x in sig0 + sig) or len(sig) != len(sig0):
                fail("29 camera: a stepped render's sweeps are not the base render's, a lane "
                     "a path each")
            lane = torch.zeros(lanes, dtype=torch.bool, device=DEVICE)
            for a, b in zip(sig0, sig):
                lane |= a != b
            moved[k, sgn] = int(lane.sum())
            unstable[torch.nonzero(lane).flatten() % (w * h)] = True  # x fastest, then y
    keep_px = (~unstable).reshape(h, w)
    n_px = int(keep_px.sum())
    weights = keep_px.to(torch.float32)[..., None] / (w * h * 3)
    masked = lambda img: (img * weights).sum()
    _, gm = dg.grad_loss_wrt_camera(scene, camera, ccfg, scfg, masked)
    fdv, fd_full = [0.0] * 3, [0.0] * 3
    for k in (1, 2):
        dif = (imgs[k, 1.0] - imgs[k, -1.0]) / (2 * CAM_FD_STEP)
        fdv[k] = float((dif * weights.double()).sum())
        fd_full[k] = float(dif.mean())
        ad = float(gm.cam_to_world[k, 3])
        if abs(ad - fdv[k]) > CAM_FD_RTOL * max(abs(fdv[k]), 1e-9):
            fail(f"29 camera: d loss / d translation {k} {ad} over the {n_px} pixels whose "
                 f"samples keep their visibility, against its central difference {fdv[k]}")
    with torch.no_grad():
        g1 = kernel_part(g1t, "29 camera", "G1", hg.hit_vjp_plain, hg.hit_vjp, g1_bound_ms,
                         check_g1, lambda *a, **kw: a[0].shape[0])
    del g1t
    best_c = timed_best(go_c, 1)
    print(f"[29 camera] the same Cornell box, depth {GRAD_CAM_DEPTH}, grad_loss_wrt_camera: "
          f"launches {shown(counts_c)}; every K3 launch within {TOL} of its plain version; the "
          f"gradient within {TOL} x max|g| of the plain gradient (max abs err {err_c:.3g}); "
          f"samples whose visibility changes under steps of {CAM_FD_STEP} in y, z: "
          f"{moved[1, 1.0]}, {moved[1, -1.0]}, {moved[2, 1.0]}, {moved[2, -1.0]} of {lanes}; "
          f"over the {n_px} of {w * h} pixels none of whose samples changes, d/d translation "
          f"y, z {float(gm.cam_to_world[1, 3]):.6g}, {float(gm.cam_to_world[2, 3]):.6g} against "
          f"central differences {fdv[1]:.6g}, {fdv[2]:.6g} (rtol {CAM_FD_RTOL}); over every "
          f"pixel {float(gc.cam_to_world[1, 3]):.6g}, {float(gc.cam_to_world[2, 3]):.6g} "
          f"against {fd_full[1]:.6g}, {fd_full[2]:.6g} (not held: the boundary term); "
          f"{lanes / best_c:.6g} paths/s forward and backward ({card})", flush=True)
    print_part("G1", "29 camera", g1, card)
    out["camera"] = dict(counts=counts_c, paths_per_s=lanes / best_c, moved=list(moved.values()),
                         pixels_held=n_px, ad=[float(gm.cam_to_world[k, 3]) for k in (1, 2)],
                         fd=fdv[1:])
    del gc
    laps["camera"] = time.perf_counter() - t_phase - sum(laps.values())

    # 29.3 the textured quad: T1 on detached tables, T2 its backward
    b = SceneBuilder()
    tid = b.add_texture(tx.TEX_IMAGEMAP, {tx.TP_GAMMA_SCALE: 1.0},
                        image=ts.seeded_image(QUAD_IMAGE, 29))
    mat = b.add_matte()
    b.set_material_texture(mat, 0, tid)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                        uvs=[[0, 0], [1, 0], [1, 1], [0, 1]], material=mat)
    b.add_distant_light(from_p=(0, 0, 1), to=(0, 0, 0), L=(2.0,) * 3)
    qscene = b.finalize(DEVICE)
    qcam = cam.make_perspective(tr.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]), QUAD_RES, fov=45.0,
                                device=DEVICE)
    qcfg = rdr.RenderCfg("path", QUAD_SPP, 1, 1.0)
    qscfg = smpl.make_sampler(smpl.SOBOL, QUAD_SPP, QUAD_RES)
    qlanes = QUAD_RES[0] * QUAD_RES[1] * QUAD_SPP
    go_q = lambda: dg.grad_loss(qscene, qcam, qcfg, qscfg, mean)
    go_q()  # warm
    t1t = LaunchTimer(tk.texture_eval, keep=True)
    t2t = LaunchTimer(tk.texture_grad, keep=True)
    (_, gq), counts_q = counted(go_q, dict(texture_eval=t1t, texture_grad=t2t),
                                dict(sobol=2, full_sweep=2, any_sweep=1, texture_eval=1,
                                     texture_grad=1), "29 quad")
    err_q = grads_close("29 quad", gq, plain_grad(go_q)[1])
    worst = {}
    with torch.no_grad():
        t1 = t1_part(t1t, "29 quad")
        t2 = kernel_part(t2t, "29 quad", "T2", tk.texture_grad_plain, tk.texture_grad,
                         t2_bound_ms, lambda *a: check_t2(*a, worst=worst),
                         lambda tb, ids, *a: ids.numel())
    del t1t, t2t
    best_q = timed_best(go_q, 1)
    print(f"[29 quad] a quad textured by a {QUAD_IMAGE[1]}x{QUAD_IMAGE[0]} image map (its MIP "
          f"pyramid read through the camera rays' footprints) at {QUAD_RES[0]}x{QUAD_RES[1]}, "
          f"{QUAD_SPP} spp, depth 1, grad_loss(mean): launches {shown(counts_q)}; the gradient "
          f"(tex_atlas, tex_params) within {TOL} x max|g| of the plain gradient (max abs err "
          f"{err_q:.3g}); T2 within 1e-3 + 1e-5 x max of its twin, the largest entry error "
          f"{worst.get('t2_rel', 0.0):.3g} of its limit; {qlanes / best_q:.6g} paths/s forward "
          f"and backward ({card})", flush=True)
    print_part("T1", "29 quad", t1, card)
    print_part("T2", "29 quad", t2, card, tol="1e-3 + 1e-5 x max")
    out["quad"] = dict(counts=counts_q, paths_per_s=qlanes / best_q)
    del gq
    laps["quad"] = time.perf_counter() - t_phase - sum(laps.values())

    # 29.4 the Mitchell filter: R1 splats the batch, R2 its backward
    mitchell = fm.make_filter(fm.FILTER_MITCHELL)
    go_m = lambda: dg.grad_loss(scene, camera, cfg, scfg, mean, filter_cfg=mitchell)
    go_m()  # warm
    r1t = LaunchTimer(rk.splat, keep=True, copy=True)
    r2t = LaunchTimer(rk.splat_grad, keep=True)
    (_, gm), counts_m = counted(go_m, dict(splat=r1t, splat_grad=r2t),
                                dict(sobol=2, full_sweep=GRAD_DEPTH + 1, any_sweep=GRAD_DEPTH,
                                     splat=1, splat_grad=1), "29 mitchell")
    err_m = grads_close("29 mitchell", gm, plain_grad(go_m)[1])
    with torch.no_grad():
        r1 = r1_part(r1t, "29 mitchell")
        r2 = kernel_part(r2t, "29 mitchell", "R2", rk.splat_grad_plain, rk.splat_grad,
                         r2_bound_ms, lambda what, got, want, a: check_fourier(what, (got,),
                                                                               (want,)),
                         lambda cfg_, p_film, *a: p_film.shape[0])
    del r1t, r2t
    best_m = timed_best(go_m, 1)
    print(f"[29 mitchell] the Cornell box's gradient render with {mitchell}: launches "
          f"{shown(counts_m)}; the gradient within {TOL} x max|g| of the plain gradient (max "
          f"abs err {err_m:.3g}); {lanes / best_m:.6g} paths/s forward and backward ({card})",
          flush=True)
    print_part("R1", "29 mitchell", r1, card, tol="2 n 2^-24 of each pixel's |terms|")
    print_part("R2", "29 mitchell", r2, card)
    out["mitchell"] = dict(counts=counts_m, paths_per_s=lanes / best_m)
    del gm
    laps["mitchell"] = time.perf_counter() - t_phase - sum(laps.values())

    # 29.5 the tall box's translation: interior by autograd (G1 with the
    # vertices' gradient) plus the silhouettes' boundary, against a central
    # difference, as tests/test_grad.py:178-237 holds the short box
    res = TRANS_RES
    tscene, tcam = presets.cornell_box((res, res), device=DEVICE)
    mask = torch.zeros(tscene.n_tris, dtype=torch.bool, device=DEVICE)
    mask[TALL_BOX] = True
    # raised 2 units: the box's bottom face is coplanar with the floor
    tscene = geo.translate_tris(tscene, mask, torch.tensor([0.0, 2.0, 0.0], device=DEVICE))
    tcfg = rdr.RenderCfg("path", TRANS_SPP, 1, 1.0)
    tscfg = smpl.make_sampler(smpl.SOBOL, TRANS_SPP, (res, res))
    ys, xs = torch.meshgrid(torch.arange(res, device=DEVICE), torch.arange(res, device=DEVICE),
                            indexing="ij")
    pf = torch.stack([xs.flatten() + 0.5, ys.flatten() + 0.5], -1).float()
    rays = cam.generate_rays(tcam, pf, torch.zeros((res * res, 2), device=DEVICE),
                             torch.zeros(res * res, device=DEVICE))
    it = si.scene_intersect(tscene, rays.o, rays.d, torch.full((res * res,), 1e30, device=DEVICE))
    floor_rows = ((it.p[:, 1] < 1.0) & it.valid).reshape(res, res).any(1)
    r0 = int(torch.nonzero(floor_rows)[0]) - 4  # the loss on the rows above the floor's
    wimg = torch.zeros((res, res), device=DEVICE)
    wimg[:r0] = 1.0 / (res * res)
    direction = (1.0, 0.0, 0.0)
    g1v = LaunchTimer(hg.hit_vjp, keep=True)
    with ExitStack() as es:
        patched(es, hit_vjp=g1v)
        zero_counts()
        interior, _, _ = geo.grad_loss_wrt_translation(tscene, tcam, tcfg, tscfg, mask,
                                                       direction, wimg, samples_per_edge=1)
        torch.cuda.synchronize()
        counts_t = read_counts()
    if counts_t["hit_grad"] < 1 or counts_t["bounce"] != 0:
        fail(f"29 translation launches {counts_t}: G1 never launched, or K2 did")
    bs = [float(geo.edge_boundary_grad(tscene, tcam, tcfg, tscfg, mask, direction, wimg,
                                       samples_per_edge=TRANS_EDGE_SAMPLES, seed=sd))
          for sd in range(TRANS_SEEDS)]
    total = float(interior) + sum(bs) / len(bs)

    def loss_at(theta):
        s2 = geo.translate_tris(tscene, mask, torch.tensor([theta, 0.0, 0.0], device=DEVICE))
        with torch.no_grad():
            return float((rdr.render(s2, tcam, tcfg, tscfg) * wimg[..., None]).sum())

    fdt = sum((loss_at(s) - loss_at(-s)) / (2 * s) for s in TRANS_STEPS) / len(TRANS_STEPS)
    if not (fdt != 0.0 and (total > 0) == (fdt > 0) and abs(total - fdt) <= TRANS_RTOL * abs(fdt)):
        fail(f"29 translation: interior {float(interior)} + boundary {bs} = {total} against the "
             f"central difference {fdt}")
    with torch.no_grad():
        g1_verts = kernel_part(g1v, "29 translation", "G1", hg.hit_vjp_plain, hg.hit_vjp,
                               g1_bound_ms, check_g1, lambda *a, **kw: a[0].shape[0])
    del g1v
    print(f"[29 translation] the tall box moving along x, {res}x{res}, {TRANS_SPP} spp, depth 1, "
          f"the loss on the {r0} rows above the floor's: interior {float(interior):.6g} + "
          f"boundary {sum(bs) / len(bs):.6g} ({TRANS_SEEDS} seeds of {TRANS_EDGE_SAMPLES} "
          f"samples an edge: {', '.join(f'{x:.4g}' for x in bs)}) = {total:.6g} against the "
          f"central difference {fdt:.6g} (steps {TRANS_STEPS}; rtol {TRANS_RTOL}, same sign); "
          f"launches of the interior term {shown(counts_t)} ({card})", flush=True)
    print_part("G1", "29 translation (g_o and g_d; the vertices' gradients each within 2 n "
               "2^-24 of their summed |terms|)", g1_verts, card)
    out["translation"] = dict(interior=float(interior), boundary=bs, fd=fdt, counts=counts_t)
    laps["translation"] = time.perf_counter() - t_phase - sum(laps.values())

    # 29.6 checkpoints: half the batches, checkpointed, resumed; bit-equal
    # to the uninterrupted render over the same batches
    batch = w * h * CK_BATCH_SPP
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        path = str(Path(tmp) / "ck.npz")
        rdr.render(scene, camera, cfg._replace(spp=GRAD_SPP // 2), scfg, max_lanes=batch,
                   checkpoint_path=path, checkpoint_every=CK_BATCH_SPP)
        nxt = rdr.load_checkpoint(path, DEVICE)[1]
        resumed = rdr.render(scene, camera, cfg, scfg, max_lanes=batch, checkpoint_path=path,
                             checkpoint_every=GRAD_SPP)
        direct = rdr.render(scene, camera, cfg, scfg, max_lanes=batch)
    if nxt != GRAD_SPP // 2 or not torch.equal(resumed, direct):
        fail(f"29 checkpoint: next sample {nxt}; the resumed image differs from the "
             f"uninterrupted one in {int((resumed != direct).sum())} values")
    print(f"[29 checkpoint] Cornell {w}x{h}, {GRAD_SPP} spp in batches of {CK_BATCH_SPP}: "
          f"checkpointed after {nxt} samples a pixel and resumed, bit-equal to the "
          f"uninterrupted render ({card})", flush=True)
    seconds = time.perf_counter() - t_phase
    laps["checkpoint"] = seconds - sum(laps.values())
    print(f"[29] phase 29 {seconds:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
          + ")", flush=True)
    return dict(out, g1=g1, g1_verts=g1_verts, t2=t2, r2=r2, seconds=seconds,
                held=dict(k5=held["full_sweep"]["max_abs_err"]))


def t3_bound_ms(tb, ids, uv, p, width, g_out) -> tuple:
    """Least time of one T3 launch, as (bytes_ms, operations_ms): T1's
    bound on the same lanes (texture_bound_ms: an upstream gradient in for
    the rgb out, the points, texels and tables read) with each point's uv
    and p gradients and each lane's width gradient written once; twice
    T1's operations, the lookup again and its reverse sweep."""
    work = texture_work(tb, ids if ids.dim() == 2 else ids[None], uv, width)
    b, o = texture_bound_ms(tb, work)
    out = (work["points"] * T3_OUT_POINT_BYTES
           + (work["live"] * T3_OUT_WIDTH_BYTES if width is not None else 0))
    return b + 1e3 * out / HBM_BYTES_PER_S, 2.0 * o


def c5_bound_ms(o, d, seg, rows, *g) -> tuple:
    """Least time of one C5 launch, as (bytes_ms, operations_ms): a hit
    lane's ray, segment id and upstream gradients in and g_o, g_d out
    (C5_HIT_LANE_BYTES), a missing lane's segment id in and its zeros out
    (C5_MISS_LANE_BYTES), each distinct hit segment's row read once;
    C5_OPS a hit lane."""
    hit = (seg >= 0) & (seg < rows.shape[0])
    n_hit = int(hit.sum())
    rows_read = int(seg[hit].unique().numel())
    nbytes = (n_hit * C5_HIT_LANE_BYTES + (o.shape[0] - n_hit) * C5_MISS_LANE_BYTES
              + rows_read * C5_ROW_BYTES)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * n_hit * C5_OPS / FP32_FLOP_PER_S


def m3_bound_ms(*a) -> tuple:
    """Least time of one M3 launch, as (bytes_ms, operations_ms).  The
    live lanes (in the medium, g_tr not 0): M2's bound on those rays alone
    (medium_bound_ms, from the plain version's work on them) with g_tr in
    and g_o, g_d out for tr out, and each lookup's reverse (M3_REVERSE_OPS)
    on top of M2's operations.  Every other lane reads in_med and g_tr and
    writes zeros (M3_IDLE_LANE_BYTES)."""
    from rs_pbrt_tpu_torch.ops import medium_kernel as mk

    live = a[6].bool() & (a[-1] != 0)
    sub = tuple(x[live] if 5 <= k <= 10 else x for k, x in enumerate(a[:-1]))
    work = {}
    mk.ratio_track_plain(*sub, work=work)
    b, o, _ = medium_bound_ms("ratio_track", sub, work)
    n_live = int(live.sum())
    idle = a[7].shape[0] - n_live
    return (b + 1e3 * (n_live * M3_EXTRA_RAY_BYTES + idle * M3_IDLE_LANE_BYTES) / HBM_BYTES_PER_S,
            o + 1e3 * work.get("lookups", 0) * M3_REVERSE_OPS / FP32_FLOP_PER_S)


def phase_camera_grads(card) -> dict:
    """Phase 29.7: grad_loss_wrt_camera of the realistic Cornell box, a
    moving quad, an image-mapped quad, the hair patch (C3 and C1) and the
    smoke (see the module's docstring, phase 29)."""
    import torch

    from rs_pbrt_tpu_torch.diff import grad as dg
    from rs_pbrt_tpu_torch.models import cameras as cam
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import curve_kernel as ck
    from rs_pbrt_tpu_torch.ops import curves as cv
    from rs_pbrt_tpu_torch.ops import hit_grad_kernel as hg
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import lens_kernel as lk
    from rs_pbrt_tpu_torch.ops import medium_kernel as mk
    from rs_pbrt_tpu_torch.ops import motion_kernel as mok
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.ops import texture as tx
    from rs_pbrt_tpu_torch.ops import texture_kernel as tk
    from rs_pbrt_tpu_torch.scene import presets
    from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
    from rs_pbrt_tpu_torch.tools import hair_scenes, sss_scenes
    from rs_pbrt_tpu_torch.tools import texture_scenes as ts
    from rs_pbrt_tpu_torch.utils import transform as tr

    t_phase = time.perf_counter()
    mean = lambda img: img.mean()
    w, h = A17C_RES
    lanes = w * h * A17C_SPP
    scfg = smpl.make_sampler(smpl.SOBOL, A17C_SPP, A17C_RES)
    cfg = lambda depth, integrator="path": rdr.RenderCfg(integrator, A17C_SPP, depth, 1.0)
    plains = dict(plain_fns(), closest_sweep=ik.closest_sweep_plain, hit_vjp=hg.hit_vjp_plain,
                  texture_grad=tk.texture_grad_plain,
                  texture_coord_grad=tk.texture_coord_grad_plain,
                  sweep_closest=cv.intersect_curves_plain,
                  sweep_any=lambda *a: cv.intersect_curves_plain(*a, any_hit=True),
                  walk_closest=cv.bvh_intersect_curves_plain,
                  walk_any=lambda *a: cv.bvh_intersect_curves_plain(*a, any_hit=True),
                  curve_vjp=ck.curve_vjp_plain, ratio_track_vjp=mk.ratio_track_vjp_plain,
                  lens_rays=lk.lens_rays_plain, anim_hits=mok.anim_hits_plain)

    # the five scenes: (tag, scene, camera, cfg, accel, the kernels that must launch)
    scene, _ = presets.cornell_box(A17C_RES, device=DEVICE)
    real = cam.make_realistic(tr.look_at(*CORNELL_VIEW), A17C_RES, SINGLET, aperture_diameter=8.0,
                              focus_distance=1078.0, film_diag_mm=35.0, device=DEVICE)
    cases = [("realistic", scene, real, cfg(2), None, ("lens",))]
    b = SceneBuilder()
    m = b.add_matte(kd=(0.8,) * 3)
    quad = [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]
    b.add_animated_triangle_mesh([[0, 1, 2], [0, 2, 3]], quad, tr.translate((0, 0, 0)),
                                 tr.translate((0.3, 0, 0)), material=m)
    b.add_point_light(p=(0.5, 0.5, 2.0), I=(5.0,) * 3)
    look = cam.make_perspective(tr.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]), A17C_RES, fov=45.0,
                                device=DEVICE)
    cases.append(("moving", b.finalize(DEVICE), look, cfg(1), None,
                  ("motion_closest", "hit_grad")))
    b = SceneBuilder()
    tid = b.add_texture(tx.TEX_IMAGEMAP, {tx.TP_GAMMA_SCALE: 1.0},
                        image=ts.seeded_image(A17C_IMAGE, 297))
    m = b.add_matte()
    b.set_material_texture(m, 0, tid)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], quad, uvs=[[0, 0], [1, 0], [1, 1], [0, 1]],
                        material=m)
    b.add_point_light(p=(0.5, 0.5, 2.0), I=(5.0,) * 3)
    near = cam.make_perspective(tr.look_at([0.2, 0.1, 4], [0, 0, 0], [0, 1, 0]), A17C_RES,
                                fov=20.0, device=DEVICE)
    cases.append(("quad", b.finalize(DEVICE), near, cfg(1), None,
                  ("texture_eval", "texture_coord_grad")))
    hair, hcam = hair_scenes.hair_patch(A17C_RES, device=DEVICE)
    cases.append(("hair C3", hair, hcam, cfg(1), None, ("curve_sweep_closest", "curve_grad")))
    with mock.patch.object(si, "BRUTE_FORCE_MAX_CURVES", A17C_TREE_ABOVE):
        tree = si.build_accel(hair, device=DEVICE)
    cases.append(("hair C1", hair, hcam, cfg(1), tree, ("curve_walk_closest", "curve_grad")))
    # phase 18's smoke: the milk sphere on its floor, the camera in the grid
    smoke, smoke_cam = sss_scenes.smoke_dragonette(SMOKE_GRID_RES, resolution=A17C_RES,
                                                   device=DEVICE)
    cases.append(("smoke", smoke, smoke_cam, cfg(1, "volpath"), None,
                  ("delta_track", "ratio_track", "ratio_track_grad")))

    timers = {k: LaunchTimer(wrapper(k), keep=True)
              for k in ("texture_coord_grad", "curve_vjp", "ratio_track_vjp")}
    out, grads = {}, {}
    for tag, sc, camera, c, accel, must in cases:
        limit = A17C_TREE_ABOVE if accel is not None else si.BRUTE_FORCE_MAX_CURVES
        with mock.patch.object(si, "BRUTE_FORCE_MAX_CURVES", limit):
            go = lambda: dg.grad_loss_wrt_camera(sc, camera, c, scfg, mean, accel=accel)
            go()  # warm
            with ExitStack() as es:
                patched(es, **timers)
                torch.cuda.synchronize()
                zero_counts()
                loss, g = go()
                torch.cuda.synchronize()
                counts = read_counts()
            with ExitStack() as es:
                patched(es, **plains)
                _, gp = go()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if any(counts[k] < 1 for k in must):
            fail(f"29 {tag} camera gradient: launches {counts}, but not every one of {must}")
        err = 0.0
        for name, a, b_ in zip(g._fields, g, gp):
            tol = TOL * float(b_.abs().max())
            err = max(err, float((a - b_).abs().max()))
            if not bool(torch.isfinite(a).all()) or not torch.allclose(a, b_, rtol=TOL, atol=tol):
                fail(f"29 {tag}: d loss / d {name} differs from the plain gradient by up to "
                     f"{float((a - b_).abs().max())} (tolerance {TOL} x {float(b_.abs().max())})")
        if float(g.cam_to_world.abs().max()) == 0.0:
            fail(f"29 {tag}: the camera gradient is 0")
        grads[tag] = g
        shown = {k: v for k, v in counts.items() if v}
        print(f"[29 {tag}] grad_loss_wrt_camera {w}x{h}, {A17C_SPP} spp, {c.integrator} depth "
              f"{c.max_depth}: loss {float(loss):.6f}; launches {shown}; the gradient finite and "
              f"within {TOL} x max|g| of the plain gradient (max abs err {err:.3g}); d loss / d "
              f"translation {[round(float(x), 8) for x in g.cam_to_world[:3, 3]]}; "
              f"{lanes / wall:.6g} paths/s forward and backward ({card})", flush=True)
        out[tag] = dict(counts=counts, paths_per_s=lanes / wall)
    c1, c3 = grads["hair C1"].cam_to_world, grads["hair C3"].cam_to_world
    if not torch.allclose(c1, c3, rtol=TOL, atol=TOL * float(c3.abs().max())):
        fail(f"29 hair: C1's camera gradient differs from C3's by {float((c1 - c3).abs().max())}")
    with torch.no_grad():
        parts = dict(
            t3=kernel_part(timers["texture_coord_grad"], "29 quad", "T3",
                           tk.texture_coord_grad_plain, tk.texture_coord_grad, t3_bound_ms,
                           check_t2, lambda tb, ids, *a: ids.numel()),
            c5=kernel_part(timers["curve_vjp"], "29 hair", "C5", ck.curve_vjp_plain, ck.curve_vjp,
                           c5_bound_ms, check_t2, lambda *a: a[0].shape[0]),
            m3=kernel_part(timers["ratio_track_vjp"], "29 smoke", "M3", mk.ratio_track_vjp_plain,
                           mk.ratio_track_vjp, m3_bound_ms, check_t2,
                           lambda *a: a[7].shape[0]))
    for kid, key in (("T3", "t3"), ("C5", "c5"), ("M3", "m3")):
        print_part(kid, "29 camera gradients", parts[key], card, tol="1e-3 + 1e-5 x max")
    seconds = time.perf_counter() - t_phase
    print(f"[29 camera gradients] C1's gradient within {TOL} of C3's; {seconds:.1f} s ({card})",
          flush=True)
    return dict(out, **parts, seconds=seconds)


def _counted(go, **recorders):
    """(go(), the launch counts of that run alone), the wrappers named in
    recorders swapped for them during the run."""
    import torch

    with ExitStack() as es:
        patched(es, **recorders)
        torch.cuda.synchronize()
        zero_counts()
        out = go()
        torch.cuda.synchronize()
        return out, read_counts()


def _hits_equal(what: str, got, want):
    """Fails unless two closest hits agree: valid and tri equal, t, b0 and b1
    bit-equal where valid."""
    import torch

    v = want.valid
    if not (torch.equal(got.valid, v) and torch.equal(got.tri[v], want.tri[v])):
        fail(f"{what}: valid or tri differs from K3 on the whole table")
    for k in ("t", "b0", "b1"):
        if not torch.equal(getattr(got, k)[v], getattr(want, k)[v]):
            err = float((getattr(got, k)[v] - getattr(want, k)[v]).abs().max())
            fail(f"{what}: {k} differs from K3 on the whole table by up to {err}")


def _geom_inputs():
    """Phase 6's random input: 262,144 rays and 2,048 triangles, and the
    triangles' vertices on the host."""
    from rs_pbrt_tpu_torch.scene import arrays as sa
    from rs_pbrt_tpu_torch.tools import sweep_replay as sr

    o, d, t_max = sr.random_rays(sr.SWEEP_RAYS, 6, DEVICE)
    table = sr.random_table(sr.SWEEP_TRIS, 6, DEVICE)
    verts = table[:, sa.TA_P0:sa.TA_P0 + 9].cpu().numpy()
    return o, d, t_max, table, (verts[:, 0:3], verts[:, 3:6], verts[:, 6:9])


def shard_rank(rank: int, world: int, out: Path):
    """One rank of phase 30's world on the one card (python3 chip_smoke.py
    --shard-rank RANK WORLD DIR): joins a gloo group through a file in DIR
    (NCCL takes no two ranks on one card), renders the flagship at
    SHARD_SPP through render(mesh=) and sweeps phase 6's random input with
    geometry_sharded_intersect, the counters zeroed just before each and
    read just after; writes DIR/rank<r>.json (counts, times) and, rank 0,
    DIR/rank0.pt (the image and the hit)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.parallel import distributed as pd
    from rs_pbrt_tpu_torch.parallel import mesh as pm
    from rs_pbrt_tpu_torch.scene import presets

    mesh = pm.make_mesh(DEVICE)
    scene, camera = presets.cornell_box(RES, device=DEVICE)
    cfg = rdr.RenderCfg("path", SHARD_SPP, DEPTH, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, SHARD_SPP, RES)
    lanes = RES[0] * RES[1] * SHARD_SPP
    img, c_render = _counted(lambda: rdr.render(scene, camera, cfg, scfg, max_lanes=lanes,
                                                mesh=mesh))
    walls = []
    for _ in range(3):
        st = {}
        rdr.render(scene, camera, cfg, scfg, max_lanes=lanes, mesh=mesh, stats=st)
        walls.append(st["wall_s"])
    o, d, t_max, _, verts = _geom_inputs()
    shards = pd.build_geom_shards(*verts, mesh.size())
    hit, c_geom = _counted(lambda: pd.geometry_sharded_intersect(shards, mesh, "d", o, d, t_max))
    geom_ms = cuda_ms(lambda: pd.geometry_sharded_intersect(shards, mesh, "d", o, d, t_max), 5)
    (out / f"rank{rank}.json").write_text(json.dumps(dict(
        render=c_render, geom=c_geom, wall_s=walls, geom_ms=geom_ms,
        rows=list(pm.band(RES[1], world, rank)), shard_rows=int(shards.n_valid[rank]))))
    if rank == 0:
        torch.save(dict(img=img.cpu(), hit={k: v.cpu() for k, v in hit._asdict().items()}),
                   out / "rank0.pt")
    dist.barrier()
    dist.destroy_process_group()


def _spawn_world(out: Path) -> list:
    """Runs SHARD_WORLD ranks of shard_rank and joins them against
    SHARD_DEADLINE, killing them all where one fails or time runs out.
    Returns each rank's json."""
    procs = []
    for r in range(SHARD_WORLD):
        with open(out / f"log{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank", str(r),
                 str(SHARD_WORLD), str(out)], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() - t0 > SHARD_DEADLINE:
                r = bad[0] if bad else 0
                why = f"rank {r} exited {procs[r].poll()}" if bad else f"over {SHARD_DEADLINE} s"
                fail(f"30 world of {SHARD_WORLD}: {why}:\n"
                     f"{(out / f'log{r}.txt').read_text()[-3000:]}")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            fail(f"30 world of {SHARD_WORLD}: rank {r} exited {p.returncode}:\n"
                 f"{(out / f'log{r}.txt').read_text()[-3000:]}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(SHARD_WORLD)]


def phase_sharding(card, flag_img, flag_paths_per_s, grad_ref) -> dict:
    """Phase 30: parallel/mesh.py and parallel/distributed.py on the card,
    a world of one over NCCL in this process, then a world of two ranks on
    the same card over gloo.  flag_img, flag_paths_per_s: phase 5's image
    and paths/s; grad_ref: phase 29's (loss, gradient)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from rs_pbrt_tpu_torch.diff import grad as dg
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.parallel import distributed as pd
    from rs_pbrt_tpu_torch.parallel import mesh as pm
    from rs_pbrt_tpu_torch.scene import presets

    t_phase = time.perf_counter()
    mesh = pm.make_mesh(DEVICE)
    backend = dist.get_backend()
    if mesh.size() != 1 or (DEVICE == "cuda" and backend != "nccl"):
        fail(f"30: make_mesh() gave {mesh.size()} ranks over {backend}, expected one over NCCL")
    total = dict.fromkeys(read_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # 30.1 the flagship through render(mesh=), every launch held as in phase 5
    scene, camera = presets.cornell_box(RES, device=DEVICE)
    cfg = rdr.RenderCfg("path", SPP, DEPTH, 1.0)
    scfg = smpl.make_sampler(smpl.SOBOL, SPP, RES)
    lanes = RES[0] * RES[1] * SPP
    go = lambda m, stats=None: rdr.render(scene, camera, cfg, scfg, max_lanes=lanes, stats=stats,
                                          mesh=m)
    k1r = LaunchTimer(sk.sobol_dims, keep=True)
    k2r = LaunchTimer(pk.bounce, keep=True, copy=True)
    img, counts = _counted(lambda: go(mesh), sobol_dims=k1r, bounce=k2r)
    if counts != expect_counts(sobol=1, bounce=DEPTH + 1):
        fail(f"30 flagship: launch counts {counts}, expected K1 1, K2 {DEPTH + 1}")
    add(counts)
    if not torch.equal(img, flag_img):
        fail(f"30 flagship: render(mesh=) differs from phase 5's render by up to "
             f"{float((img - flag_img).abs().max())}")
    (_, a1, kw1, out1), = k1r.calls
    if not torch.equal(out1, sk.sobol_dims_plain(*a1, **kw1)):
        fail("30 flagship: K1 differs from its plain version")
    k2_err = max(check_k2_launch(f"30 flagship K2 launch {b}", out, pk.bounce_plain(*a, **kw))
                 for b, (_, a, kw, out) in enumerate(k2r.calls))
    del k1r, k2r, a1, out1
    best = {}
    for _ in range(3):  # in turns: with the mesh, without
        for tag, m in (("mesh", mesh), ("render", None)):
            st = {}
            go(m, st)
            if tag not in best or st["wall_s"] < best[tag]["wall_s"]:
                best[tag] = st
    w, h = RES
    packed = torch.zeros((h, w, 7), device=DEVICE)
    ar_ms = cuda_ms(lambda: pm.all_reduce(packed, mesh), 20)
    print(f"[30 flagship] world of one over {backend}: render(mesh=make_mesh()) of the Cornell "
          f"box {w}x{h}, {SPP} spp, depth {DEPTH}: bit-equal to phase 5's render; launches K1 "
          f"{counts['sobol']}, K2 {counts['bounce']}, K1 bit-equal to its plain version, every "
          f"K2 launch within {TOL} (max abs err {k2_err:.3g}), alive equal; "
          f"{best['mesh']['paths_per_s']:.6g} camera paths/s with the mesh "
          f"({1e3 * best['mesh']['wall_s']:.3f} ms), {best['render']['paths_per_s']:.6g} "
          f"without ({1e3 * best['render']['wall_s']:.3f} ms), best of 3 in turns (phase 5: "
          f"{flag_paths_per_s:.6g}); the film's "
          f"all-reduce ({h}x{w}x7 floats) {ar_ms:.4f} ms ({card})", flush=True)

    # 30.2 geometry sharding: K3 on the rank's triangle range
    o, d, t_max, table, verts = _geom_inputs()
    shards = pd.build_geom_shards(*verts, mesh.size())
    k3r = LaunchTimer(ik.closest_sweep)
    geo = lambda: pd.geometry_sharded_intersect(shards, mesh, "d", o, d, t_max)
    hit, counts = _counted(geo, closest_sweep=k3r)
    if counts != expect_counts(closest_sweep=1):
        fail(f"30 geometry: launch counts {counts}, expected K3 once")
    add(counts)
    whole = ik.closest_sweep(o, d, t_max, table, table.shape[0])
    _hits_equal("30 geometry (world of one)", hit, whole)
    k3_ms = k3r.times_ms()[0]
    geo_ms = cuda_ms(geo, 10)
    whole_ms = cuda_ms(lambda: ik.closest_sweep(o, d, t_max, table, table.shape[0]), 10)
    bms, fms = isect_bound_ms("closest", (o, d, t_max, table, table.shape[0]), None)
    print(f"[30 geometry] geometry_sharded_intersect of {o.shape[0]} rays over "
          f"{table.shape[0]} triangles in {mesh.size()} shard: valid, tri, t, b0, b1 equal to K3 "
          f"on the whole table; K3 launched once, {k3_ms:.4f} ms by events; the call "
          f"{geo_ms:.4f} ms, K3 on the whole table {whole_ms:.4f} ms, bound {max(bms, fms):.4f} "
          f"ms ({card})", flush=True)

    # 30.3 BDPT, SPPM and MLT: the world of one against one device's render,
    # the same launches
    sres = SHARD_SMALL_RES
    sscene, scamera = presets.cornell_box(sres, device=DEVICE)
    sscfg = smpl.make_sampler(smpl.SOBOL, SHARD_SMALL_SPP, sres)
    small = {}
    for integ, extra in (("bdpt", None), ("sppm", dict(n_iterations=SPPM_ITERATIONS)),
                         ("mlt", SHARD_MLT)):
        c = rdr.RenderCfg(integ, SHARD_SMALL_SPP, SHARD_SMALL_DEPTH, 1.0, extra=extra)
        want, c_want = _counted(lambda: rdr.render(sscene, scamera, c, sscfg))
        got, c_got = _counted(lambda: rdr.render(sscene, scamera, c, sscfg, mesh=mesh))
        if c_got != c_want:
            fail(f"30 {integ}: launches {c_got} with the mesh, {c_want} without")
        add(c_got)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and torch.allclose(got, want, rtol=SHARD_TOL,
                                                               atol=SHARD_TOL * 0.1)):
            fail(f"30 {integ}: render(mesh=) differs from render by up to {err}")
        small[integ] = dict(exact=bool(torch.equal(got, want)), err=err,
                            counts={k: v for k, v in c_got.items() if v})
    said = [f"{k} {'bit-equal' if v['exact'] else 'max abs err %.3g' % v['err']} {v['counts']}"
            for k, v in small.items()]
    print(f"[30 small] the Cornell box {sres[0]}x{sres[1]}, depth {SHARD_SMALL_DEPTH}: BDPT "
          f"{SHARD_SMALL_SPP} spp, SPPM {SPPM_ITERATIONS} iterations, MLT {SHARD_MLT}; with "
          f"the mesh the same launches as without and the image within rtol {SHARD_TOL}, atol "
          f"{0.1 * SHARD_TOL:g}: {'; '.join(said)}", flush=True)

    # 30.4 grad_loss(mesh=) against phase 29's gradient
    gscene, gcamera = presets.cornell_box(GRAD_RES, device=DEVICE)
    gcfg = rdr.RenderCfg("path", GRAD_SPP, GRAD_DEPTH, 1.0)
    gscfg = smpl.make_sampler(smpl.SOBOL, GRAD_SPP, GRAD_RES)
    (loss, g), counts = _counted(lambda: dg.grad_loss(gscene, gcamera, gcfg, gscfg,
                                                      lambda i: i.mean(), mesh=mesh))
    if counts != expect_counts(sobol=2, full_sweep=GRAD_DEPTH + 1, any_sweep=GRAD_DEPTH):
        fail(f"30 grad: launch counts {counts}")
    add(counts)
    loss0, g0 = grad_ref
    g_err, g_exact = 0.0, bool(torch.equal(loss, loss0))
    for name, a, b in zip(g._fields, g, g0):
        tol = SHARD_TOL * 0.1 * float(b.abs().max())
        g_exact &= bool(torch.equal(a, b))
        g_err = max(g_err, float((a - b).abs().max()) if a.numel() else 0.0)
        if not torch.allclose(a, b, rtol=SHARD_TOL * 0.1, atol=tol):
            fail(f"30 grad: d loss / d {name} differs from phase 29's by up to "
                 f"{float((a - b).abs().max())}")
    how = "bit-equal to" if g_exact else "within rtol 1e-5 (max abs err %.3g) of" % g_err
    print(f"[30 grad] grad_loss(mean, mesh=make_mesh()) of phase 29's Cornell box: loss "
          f"{float(loss):.6f}, launches {({k: v for k, v in counts.items() if v})}; the "
          f"gradient {how} phase 29's ({card})", flush=True)
    dist.destroy_process_group()
    del mesh

    # 30.5 a world of two ranks on the one card, over gloo
    t_two = time.perf_counter()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    out = Path(tempfile.mkdtemp(prefix="shard_world_"))
    ranks = _spawn_world(out)
    for r, res in enumerate(ranks):
        if res["render"] != expect_counts(sobol=1, bounce=DEPTH + 1):
            fail(f"30 world of {SHARD_WORLD}: rank {r}'s render launched {res['render']}")
        if res["geom"] != expect_counts(closest_sweep=1):
            fail(f"30 world of {SHARD_WORLD}: rank {r}'s geometry launched {res['geom']}")
        add(res["render"])
        add(res["geom"])
    two = torch.load(out / "rank0.pt")
    cfg16 = rdr.RenderCfg("path", SHARD_SPP, DEPTH, 1.0)
    want = rdr.render(scene, camera, cfg16, smpl.make_sampler(smpl.SOBOL, SHARD_SPP, RES),
                      max_lanes=RES[0] * RES[1] * SHARD_SPP).cpu()
    err2 = float((two["img"] - want).abs().max())
    if not torch.allclose(two["img"], want, rtol=SHARD_TOL, atol=0.0):
        fail(f"30 world of {SHARD_WORLD}: the flagship at {SHARD_SPP} spp differs from render "
             f"by up to {err2}")
    hit2 = type(whole)(**two["hit"])
    _hits_equal(f"30 geometry (world of {SHARD_WORLD})", hit2,
                type(whole)(*(x.cpu() for x in whole)))
    paths = RES[0] * RES[1] * SHARD_SPP
    walls = [min(res["wall_s"]) for res in ranks]
    how = "bit-equal to" if err2 == 0 else "within rtol %g (max abs err %.3g) of" % (SHARD_TOL,
                                                                                     err2)
    print(f"[30 world of {SHARD_WORLD}] {SHARD_WORLD} processes on the one card over gloo, "
          f"which moves the CUDA tensors of the film's all-reduce and the hits' all_gather "
          f"itself, through host memory: the flagship at {SHARD_SPP} spp ({how} render), "
          f"rows {[res['rows'] for res in ranks]}, K1 1 and K2 {DEPTH + 1} a rank, "
          f"{paths / max(walls):.6g} camera paths/s (the slower rank's best of 3, "
          f"{1e3 * max(walls):.3f} ms; two ranks share one card: not a speed-up); "
          f"geometry_sharded_intersect over {SHARD_WORLD} shards of "
          f"{[res['shard_rows'] for res in ranks]} triangles equal to K3 on the whole table, "
          f"K3 once a rank, {max(res['geom_ms'] for res in ranks):.4f} ms a call; the world "
          f"{time.perf_counter() - t_two:.1f} s from spawn to join ({card})", flush=True)
    print(f"[30] phase 30 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(counts=total, paths_per_s=best["mesh"]["paths_per_s"],
                render_paths_per_s=best["render"]["paths_per_s"], all_reduce_ms=ar_ms,
                k3_ms=k3_ms, geo_ms=geo_ms, whole_ms=whole_ms, two_err=err2)


FRONT_END_SCENE = "assets/scenes/cornell_box.pbrt"  # phase 31
FRONT_END_INTEGRATOR = 'Integrator "path" "integer maxdepth" [5]'


def front_end_variants(tmp: Path) -> dict:
    """Phase 31's three versions of the Cornell file: tag -> (path, the
    launch counts expected of its render)."""
    text = (ROOT / FRONT_END_SCENE).read_text()
    sampler = next(line for line in text.splitlines() if line.startswith("Sampler "))
    if FRONT_END_INTEGRATOR not in text:
        fail(f"{FRONT_END_SCENE} has no line {FRONT_END_INTEGRATOR!r}")
    (tmp / "power.pbrt").write_text(text.replace(
        FRONT_END_INTEGRATOR, FRONT_END_INTEGRATOR + ' "string lightsamplestrategy" "power"'))
    (tmp / "no_sampler.pbrt").write_text(text.replace(sampler + "\n", ""))
    sweeps = dict(full_sweep=DEPTH + 1, any_sweep=DEPTH)
    return {"as_written": (ROOT / FRONT_END_SCENE, dict(sobol=2, **sweeps)),
            "power": (tmp / "power.pbrt", dict(sobol=1, bounce=DEPTH + 1)),
            "no_sampler": (tmp / "no_sampler.pbrt", dict(halton=2, **sweeps))}


def phase_front_end(card) -> dict:
    """Phase 31: main() on the three Cornell files against direct renders
    of their load_pbrt results, those against their plain renders; the
    other assets loaded on the card."""
    import tempfile

    import torch

    from rs_pbrt_tpu_torch import main as port_main
    from rs_pbrt_tpu_torch.io.image import write_png
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import halton_kernel as hk
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import path_kernel as pk
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.scene.api import load_pbrt

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, (path, launched) in front_end_variants(Path(tmp)).items():
            png = Path(tmp) / f"{tag}.png"
            printed = io.StringIO()
            zero_counts()
            with redirect_stdout(printed):
                rc = port_main.main(["--path", str(path), "--out", str(png), "--device", DEVICE])
            torch.cuda.synchronize()
            counts = read_counts()
            if rc != 0 or not png.is_file():
                fail(f"[31 {tag}] main returned {rc}: {printed.getvalue()}")
            for line in printed.getvalue().splitlines()[2:]:
                print(f"[31 {tag} main] {line}")
            t0 = time.perf_counter()
            scene, camera, cfg, scfg, fcfg, _ = load_pbrt(path, device=DEVICE)
            accel = si.build_accel(scene, kind=cfg.accelerator, device=DEVICE)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            if accel != si.Accel():
                fail(f"[31 {tag}] {path.name} built a tree; main renders it without one")
            accel = None  # as main passes it
            st = {}
            zero_counts()
            img = rdr.render(scene, camera, cfg, scfg, fcfg, accel=accel, stats=st)
            direct = read_counts()
            if counts != direct or direct != expect_counts(**launched):
                fail(f"[31 {tag}] launches through main {counts}, direct {direct}, expected "
                     f"{launched}")
            w, h = camera.resolution
            if tuple(img.shape) != (h, w, 3) or not torch.isfinite(img).all():
                fail(f"[31 {tag}] image: shape {tuple(img.shape)}, finite "
                     f"{bool(torch.isfinite(img).all())}")
            want_png = Path(tmp) / f"{tag}_direct.png"
            write_png(want_png, img)
            if png.read_bytes() != want_png.read_bytes():
                fail(f"[31 {tag}] main's PNG differs from write_png of the direct render")
            with ExitStack() as es:
                patched(es, sobol_dims=sk.sobol_dims_plain, bounce=pk.bounce_plain,
                        halton_dims=hk.halton_dims_plain, closest_sweep=ik.closest_sweep_plain,
                        any_sweep=ik.any_sweep_plain, full_sweep=ik.full_sweep_plain)
                img_plain = rdr.render(scene, camera, cfg, scfg, fcfg, accel=accel)
            err = compare_plain(f"[31 {tag}] render", img, img_plain)
            print(f"[31 {tag}] {path.name}: {w}x{h}, {scfg.spp} spp, {cfg.integrator} depth "
                  f"{cfg.max_depth}, light selection {cfg.light_strategy}, sampler kind "
                  f"{scfg.kind}; main's launches {counts} = the direct render's; main's PNG = "
                  f"write_png of it ({png.stat().st_size} bytes); within {err:.3g} of the plain "
                  f"render (mean {float(img.mean()):.5f}); parse and build {build_s:.4f} s; "
                  f"{st['paths_per_s']:.6g} camera paths/s (the direct render, warm, "
                  f"{1e3 * st['wall_s']:.3f} ms) on {card}", flush=True)
            out[tag] = dict(counts=counts, paths_per_s=st["paths_per_s"], build_s=build_s)
    for path in sorted((ROOT / "assets" / "scenes").glob("*.pbrt")):
        if path.name == Path(FRONT_END_SCENE).name:
            continue
        t0 = time.perf_counter()
        scene, camera, cfg, scfg, _, _ = load_pbrt(path, device=DEVICE)
        torch.cuda.synchronize()
        print(f"[31 load] {path.name}: {scene.n_tris} triangles, {scene.n_spheres} quadrics, "
              f"{scene.n_curve_segs} curve segments, {scene.n_lights} lights, "
              f"{len(scene.bss_eta) if scene.has_subsurface else 0} subsurface materials; "
              f"{camera.resolution[0]}x{camera.resolution[1]}, {scfg.spp} spp, "
              f"{cfg.integrator}; on {scene.device} in {time.perf_counter() - t0:.4f} s",
              flush=True)
    return out


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
    t_start = time.perf_counter()

    def lap(phases: str):
        print(f"[time] phase {phases} done {time.perf_counter() - t_start:.1f} s into the "
              "script", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    lap("2")
    k1_err = phase_k1(card)
    lap("3")
    from rs_pbrt_tpu_torch.scene import presets

    scene, camera = presets.cornell_box(RES, device=DEVICE)
    k2_err = phase_k2(card, scene, camera)
    flag = phase_render(card)
    lap("4-5")
    flag["k1"]["max_abs_err"] = max(k1_err, flag["k1"]["max_abs_err"])
    flag["k2"]["max_abs_err"] = max(k2_err, flag["k2"]["max_abs_err"])
    sweeps = phase_sweeps(card)
    lap("6")
    slices = [phase_slice_render(card, integrator) for integrator in ("directlighting", "whitted")]
    lap("7")
    probe = phase_probe(card)
    lap("8")
    statue = phase_statue(card)
    lap("9")
    later = [phase_regen_check(card, statue)]
    lap("10")
    # phase 20 reuses phase 9's statue and BVH, which go before phase 11
    later.append(phase_statue_env(card, statue))
    lap("20")
    later.append(phase_statue_disney(card, statue))
    lap("22")
    marble = phase_statue_marble(card, statue)
    later.append(marble)
    lap("24")
    print(f"[24] paths/s in this call: statue_env {later[1]['paths_per_s']:.6g}, statue_disney "
          f"{later[2]['paths_per_s']:.6g}, statue_marble {marble['paths_per_s']:.6g} ({card})",
          flush=True)
    samplers = phase_samplers(card, statue)
    later.append(samplers)
    lap("25")
    del statue["camera"], statue["scene"], statue["accel"]
    later += list(phase_spatial_crop(card).values())
    lap("11")
    later.append(phase_full_statue(card))
    lap("12")
    curves = phase_curves(card)
    lap("13")
    hair = phase_hair_renders(card)
    later += list(hair.values())
    lap("14")
    glass = phase_glass(card)
    later += list(glass.values())
    lap("15")
    caustic = phase_sppm(card)
    later += [caustic["caustic_only"], caustic["caustic_hair"]]
    lap("16")
    sss = phase_sss(card)
    later += [sss["bench"], sss["volpath"], sss["path"]]
    lap("17")
    smoke = phase_smoke(card)
    later.append(smoke)
    lap("18")
    later += list(phase_env(card).values())
    lap("19")
    grid = phase_grid(card)
    later += [grid[tag] for tag, _, _, _ in GRID_RUNS]
    lap("21")
    textures = phase_textures(card)
    later += [textures[tag] for tag, _, _, _ in TEX_RUNS]
    lap("23")
    cameras = phase_cameras(card)
    later += list(cameras["renders"].values())
    lap("26")
    a25 = phase_instances(card)
    later += [a25[k] for k in ("forest", "moving", "kd")]
    lap("27")
    bidir = phase_bidirectional(card)
    later += [bidir[k] for k in ("bdpt", "mlt", "smoke")]
    lap("28")
    grads = phase_gradients(card)
    later += [grads[k] for k in ("grad", "camera", "quad", "mitchell", "translation")]
    a17c = phase_camera_grads(card)
    later += [a17c[k] for k in ("realistic", "moving", "quad", "hair C3", "hair C1", "smoke")]
    lap("29")
    sharding = phase_sharding(card, flag.pop("img"), flag["paths_per_s"],
                              grads["grad"].pop("ref"))
    later.append(sharding)
    lap("30")
    later += list(phase_front_end(card).values())
    lap("31")
    more = lambda key: sum(p["counts"][key] for p in later)  # phases 10-12 and 14-31's launches

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
        # K3's numbers are phase 6's at the camera rays; its launches those of
        # the camera gradients (phase 29) and of the triangle shards (phase 30)
        dict(kernel_entry("closest_sweep", csrc + "intersect.cu", pallas + "133",
                          more("closest_sweep"), [sweeps["closest"]],
                          sweeps["closest"]["max_abs_err"]),
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
    # T1 replaces the JAX package's XLA texture evaluation; F.grid_sample
    # reads one image, not the atlas's per-lane rects and wrap modes
    kernels.append(dict(kernel_entry(
        "texture_eval", csrc + "texture.cu", "rs_pbrt_tpu/ops/texture.py:286",
        more("texture_eval"), [textures["texture_eval"]],
        max(textures["texture_eval"]["max_abs_err"], textures["sweep"]["max_abs_err"])),
        bit_equal=textures["texture_eval"]["exact"] and textures["sweep"]["exact"],
        sweep={k: (sum(v) / len(v) if isinstance(v, list) else v)
               for k, v in textures["sweep"].items() if k in ("ms", "device_ms", "plain_ms",
                                                                "lanes")}
        | dict(bound_ms=max(textures["sweep"]["bound"][0]))))
    # H1 replaces the JAX package's XLA Halton dims; no PyTorch call
    # computes a scrambled radical inverse
    kernels.append(dict(kernel_entry(
        "halton_dims", csrc + "halton.cu", "rs_pbrt_tpu/ops/lowdiscrepancy.py:259",
        more("halton"), [samplers["h1"]],
        max(samplers["h1"]["max_abs_err"], samplers["cases"]["max_abs_err"])),
        bit_equal=True,
        cases={k: (sum(v) / len(v) if isinstance(v, list) else v)
               for k, v in samplers["cases"].items() if k in ("ms", "device_ms", "plain_ms")}
        | dict(bound_ms=sum(max(b) for b in samplers["cases"]["bound"])
               / len(samplers["cases"]["bound"]))))
    # R1 replaces the JAX package's XLA filter splat; no one PyTorch call
    # computes it (index_put_ adds given weights, it does not filter)
    r1, r1c = cameras["r1"], cameras["r1_cases"]
    kernels.append(dict(kernel_entry(
        "film_splat", csrc + "splat.cu", "rs_pbrt_tpu/ops/film.py:117", more("splat"), [r1],
        max(r1["max_abs_err"], r1c["max_abs_err"])),
        bit_equal=False, atomics_a_launch=r1["atomics"] / len(r1["ms"]),
        tolerance="each pixel within 2 n 2^-24 of its n summed |terms|",
        cases={k: sum(r1c[k]) / len(r1c[k]) for k in ("ms", "device_ms", "plain_ms")}
        | dict(bound_ms=sum(max(b) for b in r1c["bound"]) / len(r1c["bound"]),
               atomics_a_launch=r1c["atomics"] / len(r1c["ms"]))))
    # L1 replaces the JAX package's XLA lens trace; no PyTorch call traces
    # a lens
    l1, l1c = cameras["l1"], cameras["l1_cases"]
    kernels.append(dict(kernel_entry(
        "lens_rays", csrc + "lens.cu",
        "rs_pbrt_tpu/models/realistic.py:231 + rs_pbrt_tpu/models/cameras.py:214", more("lens"),
        [l1], max(l1["max_abs_err"], l1c["max_abs_err"])),
        bit_equal=l1["exact"] and l1c["exact"],
        cases={k: sum(l1c[k]) / len(l1c[k]) for k in ("ms", "device_ms", "plain_ms")}
        | dict(bound_ms=sum(max(b) for b in l1c["bound"]) / len(l1c["bound"]))))
    # I1/I2, V1 and D1/D2 replace the JAX package's XLA walks; no PyTorch
    # call walks a tree or sweeps a moving mesh
    for name, part, key, replaces in (
            ("instance_closest", a25["forest"]["I1"], "instance_closest",
             "rs_pbrt_tpu/ops/instancing.py:256"),
            ("instance_any", a25["forest"]["I2"], "instance_any",
             "rs_pbrt_tpu/ops/instancing.py:256 (.valid, rs_pbrt_tpu/ops/scene_intersect.py:768)"),
            ("motion_sweep", a25["moving"]["V1"], ("motion_closest", "motion_any"),
             "rs_pbrt_tpu/ops/scene_intersect.py:467"),
            ("kd_closest", a25["kd"]["D1"], "kd_closest", "rs_pbrt_tpu/ops/kdtree.py:174"),
            ("kd_any", a25["kd"]["D2"], "kd_any", "rs_pbrt_tpu/ops/kdtree.py:174 (any_hit)")):
        keys = key if isinstance(key, tuple) else (key,)
        source = csrc + {"i": "instance.cu", "m": "motion.cu", "k": "kdtree.cu"}[name[0]]
        kernels.append(dict(kernel_entry(name, source, replaces, sum(more(k) for k in keys),
                                         [part], part["max_abs_err"]),
                            bit_equal=part["exact"], held=len(part["ms"])))
    # W1 replaces the JAX package's XLA MIS weight; no PyTorch call computes
    # one
    w1 = bidir["w1"]
    kernels.append(dict(kernel_entry("mis_weight", csrc + "mis.cu",
                                     "rs_pbrt_tpu/models/integrators/bdpt.py:465", more("mis"),
                                     [w1], w1["max_abs_err"]),
                        bit_equal=w1["exact"], held=bidir["w1_held"]))
    # G1, T2 and R2 replace the JAX package's reverse-mode AD through its
    # XLA hit test, texture lookup and film update; no one PyTorch call
    # computes these vector-Jacobian products
    g1s = [grads["g1"], grads["g1_verts"]]
    kernels.append(dict(kernel_entry(
        "hit_vjp", csrc + "hit_grad.cu", "rs_pbrt_tpu/ops/intersect.py:61 (jax.vjp of "
        "intersect_tri)", more("hit_grad"), g1s, max(p["max_abs_err"] for p in g1s)),
        bit_equal=all(p["exact"] for p in g1s), held=sum(len(p["ms"]) for p in g1s)))
    t2 = grads["t2"]
    kernels.append(dict(kernel_entry(
        "texture_vjp", csrc + "texture_grad.cu", "rs_pbrt_tpu/ops/texture.py:286 (jax.vjp of "
        "eval_texture)", more("texture_grad"), [t2], t2["max_abs_err"]),
        bit_equal=t2["exact"], held=len(t2["ms"]),
        tolerance="each entry within 1e-3 of the plain version's + 1e-5 of the largest"))
    r2 = grads["r2"]
    kernels.append(dict(kernel_entry(
        "splat_vjp", csrc + "splat_grad.cu", "rs_pbrt_tpu/ops/film.py:117 (jax.vjp of "
        "add_samples)", more("splat_grad"), [r2], r2["max_abs_err"]),
        bit_equal=r2["exact"], held=len(r2["ms"])))
    # T3, C5 and M3 replace the JAX package's reverse-mode AD through its
    # XLA texture lookup, curve leaf test and ratio tracking, in the
    # lookup's coordinates and the rays; no one PyTorch call computes them
    for name, key, source, replaces, count in (
            ("texture_coord_vjp", "t3", "texture_grad.cu", "rs_pbrt_tpu/ops/texture.py:286 "
             "(jax.vjp of eval_texture in uv, p, width)", "texture_coord_grad"),
            ("curve_vjp", "c5", "curve_grad.cu", "rs_pbrt_tpu/ops/curves.py:240 (jax.vjp of "
             "curve_seg_test in o, d)", "curve_grad"),
            ("ratio_track_vjp", "m3", "medium_grad.cu", "rs_pbrt_tpu/models/integrators/"
             "volpath.py:86 (jax.vjp of _ratio_track_tr in o, d)", "ratio_track_grad")):
        part = a17c[key]
        kernels.append(dict(kernel_entry(name, csrc + source, replaces, more(count), [part],
                                         part["max_abs_err"]),
                            bit_equal=part["exact"], held=len(part["ms"]),
                            tolerance="each entry within 1e-3 of the twin's + 1e-5 of the "
                                      "largest"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        shard_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    else:
        main()
