"""Command-line renderer: a .pbrt file in, a PNG out.

The port of the JAX package's ``main.py`` (reference src/bin/rs_pbrt.rs
main()), with its flag surface and its printed lines:

    python -m rs_pbrt_tpu_torch.main --path scene.pbrt [--samples N] [--device cpu]

It parses the file with the port's ``scene/api.load_pbrt``, builds the
accelerator (``ops/scene_intersect.build_accel``; none where the scene
needs no tree, so that a scene K2 takes renders through it), renders with
``models/integrators/render.render`` and writes the image with
``io/image.write_png``.  ``--device`` picks the torch device (default
``cuda``: without a card it raises; ``cpu`` runs the plain versions).  One
process drives one device: ``--ndevices`` above 1, and the Arnold
``.ass`` and Blender ``.blend`` importers (``-l``, ``-c``), come with
ROADMAP A18b and raise NotImplementedError here.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="rs_pbrt_tpu_torch",
        description="Physically based rendering (PBR) with PyTorch and CUDA")
    p.add_argument("-p", "--path", required=True, help="path to the .pbrt file")
    p.add_argument("-i", "--integrator", default=None,
                   help="ao, directlighting, whitted, path, bdpt, mlt, sppm, volpath")
    p.add_argument("-s", "--samples", type=int, default=0, help="pixel samples")
    p.add_argument("--cropx0", type=float, default=0.0)
    p.add_argument("--cropx1", type=float, default=1.0)
    p.add_argument("--cropy0", type=float, default=0.0)
    p.add_argument("--cropy1", type=float, default=1.0)
    p.add_argument("-o", "--out", default=None, help="override output filename")
    p.add_argument("--ndevices", type=int, default=0,
                   help="0 or 1: this process's one device (more: ROADMAP A18b)")
    p.add_argument("-l", "--light-scale", type=float, default=1.0,
                   help=".blend: scale all lamp emission (ROADMAP A18b)")
    p.add_argument("-c", "--camera-name", default=None,
                   help=".blend: camera Object name to render from (ROADMAP A18b)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import torch

    from rs_pbrt_tpu_torch.device import resolve
    from rs_pbrt_tpu_torch.io.image import write_png
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops.scene_intersect import Accel, build_accel
    from rs_pbrt_tpu_torch.scene.api import load_pbrt

    if str(args.path).endswith((".ass", ".blend")):
        raise NotImplementedError("the .ass and .blend importers come with ROADMAP A18b")
    if args.ndevices > 1:
        raise NotImplementedError("--ndevices above 1 (one process a card through torchrun "
                                  "and render(mesh=)) comes with ROADMAP A18b")
    dev = resolve(args.device)
    n_found = torch.cuda.device_count() if dev.type == "cuda" else 1
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"rs_pbrt_tpu_torch [Detected {n_found} device(s): {dev.type}; rendering on {dev} "
          f"({name})]")
    print("Rust reference by Jan Douglas Bert Walter; "
          "based on C++ code by Matt Pharr, Greg Humphreys, and Wenzel Jakob.")

    overrides = {}
    if args.integrator:
        overrides["integrator"] = args.integrator
    if args.samples:
        overrides["samples"] = args.samples

    t0 = time.time()
    scene, camera, cfg, sampler_cfg, filter_cfg, _ = load_pbrt(args.path, overrides, device=dev)
    print(f"Parsed + built scene in {time.time() - t0:.2f}s: "
          f"{scene.n_tris} triangles, {scene.n_spheres} spheres, "
          f"{scene.n_lights} lights")
    print(f'Sampler spp {sampler_cfg.spp}; Integrator "{cfg.integrator}"')

    accel = build_accel(scene, kind=cfg.accelerator, device=dev)
    if accel == Accel():
        # no tree: the scene is swept, and render offers the path integrator
        # to K2 only without an accelerator (the JAX main passes this empty
        # one, so its path renders never take the megakernel)
        accel = None
    crop = None
    if (args.cropx0, args.cropx1, args.cropy0, args.cropy1) != (0.0, 1.0, 0.0, 1.0):
        crop = (args.cropx0, args.cropx1, args.cropy0, args.cropy1)
    t0 = time.time()
    img = rdr.render(scene, camera, cfg, sampler_cfg, filter_cfg, accel=accel, crop=crop)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    w, h = camera.resolution
    print(f"Rendered {w}x{h} @ {cfg.spp}spp in {dt:.2f}s "
          f"({w * h * cfg.spp / dt / 1e6:.2f} Mpaths/s)")

    out = args.out or "pbrt.png"  # the reference always writes pbrt.png (film.rs:481)
    write_png(out, img)
    print(f'Writing image "{out}" with bounds (0, 0) - ({w}, {h})')
    return 0


if __name__ == "__main__":
    sys.exit(main())
