"""The torch ops a render dispatches, counted on the CPU.

    python3 rs_pbrt_tpu_torch/tools/op_count.py [--root DIR]

Renders each of the earlier slices' scenes at 8x8 on the CPU (the Cornell
box, spheres_direct, caustic_only with smooth and with rough glass,
caustic_hair, hair_patch; depth 5, 2 spp, SPPM one iteration) and prints,
per render, the aten ops it dispatched (a TorchDispatchMode counts them)
and the image's sum.  Host-bound renders pay for each op, so the count is
the BSDF layer's metric of PERF.md section 3; the sum shows that two
versions computed the same image.

``--samplers`` counts instead the ops of each sampler kind's dims: one
path bounce's 7 (the path integrator's 2D pairs, its route), the camera's
5, and a whole Cornell box path render with the kind.  Halton's and
Sobol's dims are one kernel launch each on the card; here they run their
plain versions, whose ops are counted too.

``--cameras`` counts the plain versions of this slice's two kernels: the
filter splat's ops (R1's plain version, ``splat_kernel.splat_plain``) for
each filter kind at its default radius, and the realistic camera's ray
generation (L1's, ``lens_kernel.lens_rays_plain``) for element tables of 1
to 8 spherical elements and with an aperture stop.  Each is one launch on
the card.

``--motion`` counts the f32 operations of the moving-mesh sweep's set-up
for one ray and one group (V1's plain version: the transform interpolated
at the ray's time, its inverse, the ray's origin and direction carried
into object space), each element operation of add, sub, mul, div, sqrt,
sin, acos and neg one, as PERF.md's bounds count them; chip_smoke.py
reads ``motion_ops`` for V1's operations bound.

``--bdpt`` counts one BDPT evaluation's ops (``bdpt.radiance_and_splats``
on the Cornell box's 8x8 pixels, one Sobol' sample each, depth 3 and 5)
and one MLT mutation's (``mlt._mutation_step``, 64 chains): all of them
with the MIS weights in plain PyTorch (``mis_kernel.mis_weight_plain``, as
the CPU runs them), the plain MIS weights' share, and the count with W1,
where each strategy's weight is one launch.

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


def sampler_counts():
    """Prints each sampler kind's ops: a path bounce's dims, the camera's
    dims and a Cornell box path render (2 spp, depth 5)."""
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.scene import presets

    scene, camera = presets.cornell_box(RES, device="cpu")
    cfg = rdr.RenderCfg("path", 2, 5, 1.0)
    names = dict(sobol=smpl.SOBOL, random=smpl.RANDOM, zerotwo=smpl.ZEROTWO,
                 stratified=smpl.STRATIFIED, halton=smpl.HALTON, maxmin=smpl.MAXMIN)
    for name, kind in names.items():
        scfg = smpl.make_sampler(kind, 2, RES)
        ctx, _ = rdr.camera_rays(camera, scfg, 0, 2)
        dyn = smpl.traced_route(scfg, pathmod.DIMS_PER_BOUNCE * cfg.max_depth)
        counts = []
        for draw in (lambda: smpl.get_dims(scfg, ctx, pathmod.DIM_CAMERA,
                                           pathmod.DIMS_PER_BOUNCE, pathmod.PAIRS, dyn),
                     lambda: smpl.get_camera_dims(scfg, ctx, ctx.pixel),
                     lambda: rdr.render(scene, camera, cfg, scfg)):
            with _Count() as count:
                draw()
            counts.append(sum(count.ops.values()))
        print(f"sampler {name}: a path bounce's {pathmod.DIMS_PER_BOUNCE} dims {counts[0]} ops, "
              f"the camera's 5 {counts[1]} ops; cornell_box path {counts[2]} ops", flush=True)


def camera_counts():
    """Prints the splat's ops for each filter kind and the lens trace's for
    element tables of 1, 2, 4 and 8 spheres and 2 spheres with a stop."""
    import dataclasses

    import numpy as np

    from rs_pbrt_tpu_torch.models import cameras as cam
    from rs_pbrt_tpu_torch.ops import film as fm
    from rs_pbrt_tpu_torch.ops import lens_kernel as lk
    from rs_pbrt_tpu_torch.ops import splat_kernel as rk
    from rs_pbrt_tpu_torch.utils import transform as tr

    g = torch.Generator().manual_seed(0)
    n = RES[0] * RES[1] * 2
    p_film = torch.rand((n, 2), generator=g) * torch.tensor(RES, dtype=torch.float32)
    L = torch.rand((n, 3), generator=g)
    for kind in range(5):
        cfg = fm.make_filter(kind)
        film = fm.make_film(RES, device="cpu")
        with _Count() as count:
            rk.splat_plain(film.rgb, film.weight, cfg, p_film, L)
        ops, F = sum(count.ops.values()), fm.footprint(cfg)
        print(f"splat {cfg}: {ops} ops, {F} x {F} taps, {ops / (F * F):.1f} ops a tap",
              flush=True)
    singlet = [50.0, 5.0, 1.5, 20.0, -50.0, 45.0, 1.0, 20.0]
    camera = cam.make_realistic(tr.look_at((0, 0, -5), (0, 0, 0), (0, 1, 0)), RES, singlet,
                                aperture_diameter=8.0, focus_distance=5.0, device="cpu")
    u_lens = torch.rand((n, 2), generator=g)
    sphere, stop = [1.0, 1.0, 1.5, 20.0], [0.0, 1.0, 0.0, 10.0]
    tables = {f"{e} spheres": [sphere] * e for e in (1, 2, 4, 8)}
    tables["2 spheres and a stop"] = [sphere, sphere, stop]
    for name, rows in tables.items():
        rows = np.asarray(rows, np.float32) * np.asarray([0.05, 0.005, 1.0, 0.001], np.float32)
        rows[-1, 1] = camera.lens[-1, 1]
        table = dataclasses.replace(camera, lens=torch.as_tensor(rows))  # builds its constants
        with _Count() as count:
            lk.lens_rays_plain(table, p_film, u_lens)
        print(f"lens trace, {name}: {sum(count.ops.values())} ops", flush=True)


def bdpt_counts():
    """Prints the ops of a BDPT evaluation and of an MLT mutation as the
    card dispatches them: every op outside the kernels' wrappers, and a
    launch for each wrapper call (K1, K4, K5, W1), with the plain MIS
    weights' ops in place of W1's launches beside it."""
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import bdpt, mlt
    from rs_pbrt_tpu_torch.models.integrators import path as pathmod
    from rs_pbrt_tpu_torch.ops import film as fm
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik
    from rs_pbrt_tpu_torch.ops import mis_kernel as misk
    from rs_pbrt_tpu_torch.ops import sobol_kernel as sk
    from rs_pbrt_tpu_torch.scene import presets

    wrappers = ((sk, "sobol_dims"), (ik, "any_sweep"), (ik, "full_sweep"),
                (ik, "closest_sweep"), (misk, "mis_weight"))

    class Split(TorchDispatchMode):
        """Counts ops by the kernel wrapper they run in ("host" outside)."""

        def __init__(self):
            super().__init__()
            self.ops, self.calls, self.part = Counter(), Counter(), "host"

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[self.part] += 1
            return func(*args, **(kwargs or {}))

    def counted(go):
        with Split() as mode:
            real = {}
            for mod, name in wrappers:
                real[name] = fn = getattr(mod, name)

                def traced(*a, fn=fn, name=name, **kw):
                    mode.part = name
                    mode.calls[name] += 1
                    try:
                        return fn(*a, **kw)
                    finally:
                        mode.part = "host"
                setattr(mod, name, traced)
            try:
                go()
            finally:
                for mod, name in wrappers:
                    setattr(mod, name, real[name])
        launches = sum(mode.calls.values())
        card = mode.ops["host"] + launches
        return (f"{card} host ops on the card ({mode.ops['host']} plain ops and {launches} "
                f"launches: {dict(mode.calls)}); with the MIS weights in plain PyTorch "
                f"{card - mode.calls['mis_weight'] + mode.ops['mis_weight']} ("
                f"{mode.ops['mis_weight']} ops, "
                f"{mode.ops['mis_weight'] / max(mode.calls['mis_weight'], 1):.1f} a weight)")

    scene, camera = presets.cornell_box(RES, device="cpu")
    cfg = smpl.make_sampler(smpl.SOBOL, 1, RES)
    n = RES[0] * RES[1]
    xs = torch.arange(RES[0]).repeat(RES[1])
    pix = torch.stack([xs, torch.arange(RES[1]).repeat_interleave(RES[0])], -1)
    ctx = smpl.make_ctx(cfg, pix, torch.zeros(n, dtype=torch.int64), frame_lt_spp=True)
    p_film = pix.to(torch.float32) + 0.5
    for depth in (3, 5):
        pcfg = pathmod.PathCfg(depth, 1.0)
        print(f"bdpt evaluation, depth {depth}: " + counted(
            lambda: bdpt.radiance_and_splats(scene, camera, pcfg, cfg, ctx, p_film)), flush=True)
        n_pss = mlt.n_pss_for_depth(depth)
        g = torch.Generator().manual_seed(0)
        pss = torch.rand((64, n_pss), generator=g)
        scfg = smpl.make_sampler(smpl.RANDOM, 1, RES)
        ev = mlt._eval_target(scene, camera, pcfg, scfg, pss, None)
        film = fm.make_film(RES, device="cpu")
        u = mlt.mutation_uniforms(g, 64, n_pss, "cpu")
        print(f"mlt mutation, depth {depth}: " + counted(
            lambda: mlt._mutation_step(scene, camera, pcfg, scfg, None, False, None, pss, ev,
                                       film, u)), flush=True)


ARITH = ("add", "sub", "rsub", "mul", "div", "sqrt", "sin", "acos", "neg")


def motion_ops() -> int:
    """The arithmetic element operations of V1's set-up for one ray and one
    group (interpolate, inverse_affine, xform_point, xform_vector)."""
    import numpy as np

    from rs_pbrt_tpu_torch.utils import animated as an
    from rs_pbrt_tpu_torch.utils import transform as tr

    m0, m1 = np.eye(4), np.diag([2.0, 2.0, 2.0, 1.0])
    m1[:3, 3] = (1.0, 2.0, 3.0)
    parts = [torch.as_tensor(p) for p in an.decompose(m0) + an.decompose(m1)]
    t, o, d = torch.tensor([0.3]), torch.ones((1, 3)), torch.ones((1, 3))

    class Arith(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.__name__.split(".")[0].rstrip("_") in ARITH and torch.is_tensor(out):
                Arith.n += out.numel()
            return out

    with Arith():
        mi = an.inverse_affine(an.interpolate(t, *parts))
        tr.xform_point(mi, o)
        tr.xform_vector(mi, d)
    return Arith.n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose rs_pbrt_tpu_torch is counted")
    ap.add_argument("--samplers", action="store_true",
                    help="count each sampler kind's dims instead of the scenes' renders")
    ap.add_argument("--cameras", action="store_true",
                    help="count the filter splat's and the lens trace's ops instead")
    ap.add_argument("--motion", action="store_true",
                    help="count the moving-mesh sweep's operations a ray and group instead")
    ap.add_argument("--bdpt", action="store_true",
                    help="count a BDPT evaluation's and an MLT mutation's ops instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    if args.bdpt:
        torch.set_num_threads(2)
        bdpt_counts()
        return 0
    if args.motion:
        print(f"moving-mesh set-up: {motion_ops()} f32 operations a ray and group", flush=True)
        return 0
    if args.samplers or args.cameras:
        torch.set_num_threads(2)
        sampler_counts() if args.samplers else camera_counts()
        return 0
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
