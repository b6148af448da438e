"""Shared set-up of the port's tests of BDPT and MLT: the test scenes as
calls on either package's builder, seeded lanes, and the JAX package's
results computed in subprocesses whose XLA contracts no FMAs
(XLA_FLAGS=--xla_cpu_max_isa=SSE4_2), through ``_a25scene.JaxJobs`` with
this module's program.  XLA compiles a BDPT evaluation once per scene
shape (~30-60 s at depth 3: its (s, t) strategies unroll), so each job
jits one function of (scene, lanes) and calls it on every lane set it is
given.

Jobs (kind, options); results land in the job's npz under "tag:name":
- "lanes": options scene, sampler ("random" or "sobol"), spp, depth and
  sets, a list of (name, crop rect or None); for each set the lanes
  "tag:name:pix" (N, 2) and "tag:name:sn" (N,) of the inputs, and
  radiance_and_splats on them: "name:pf", "name:L", "name:sp", "name:sl",
  and the image render_bdpt makes of those lanes with the JAX film
  functions, "name:img" (spp the set's samples a pixel, its "tag:name:spp").
- "mlt": options depth, n (the bootstrap samples and the chains), seed,
  steps: the JAX _bootstrap_chains from PRNGKey(seed), with its draws
  ("boot", "u_pick") and its results ("b", "pss", "ev0".."ev4"), then
  `steps` _mutation_steps from there fed the inputs' "tag:u<k>_large",
  "_fresh", "_noise", "_accept": each step's pss ("pss<k>"), accept
  ("acc<k>") and evaluation ("ev<k>_<i>"), and the film's splat layer
  ("splat").
- "strat": _eval_target with depth_stratified on the inputs' "tag:pss"
  (options depth): "ev0".."ev4".
"""

import numpy as np

from _volpath import WALL_Z, grid, hetero_density

RES = 8
DEPTH = 3
SPP = 2
DELTA_LOOK = ([0, 2.2, 6.5], [0, 1.0, 0], [0, 1, 0], 45.0)
FOG_LOOK = ([0, 5, -10], [0, 0, 0], [0, 1, 0], 40.0)
GRID_LOOK = ([0, 0, 0], [0, 0, WALL_Z], [0, 1, 0], 30.0)
CROP = (0.25, 0.75, 0.25, 0.75)  # 4 x 4 of the 8 x 8 pixels


def delta_build(b, tr):
    """Point, spot and distant lights over a matte floor, a matte sphere and
    a mirror sphere (delta BSDF vertices)."""
    floor = b.add_matte(kd=(0.6, 0.6, 0.6))
    matte = b.add_matte(kd=(0.5, 0.2, 0.2))
    mirror = b.add_mirror(kr=(0.9, 0.9, 0.9))
    quad = np.asarray([[-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6]], np.float32)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], quad, material=floor)
    b.add_sphere(tr.translate([-1.1, 1.0, 0]), radius=1.0, material=matte)
    b.add_sphere(tr.translate([1.1, 1.0, 0.4]), radius=1.0, material=mirror)
    b.add_point_light(p=(-2.0, 3.0, 2.0), I=(6.0, 5.0, 4.0))
    b.add_spot_light(p=(0.5, 3.0, 0.5), to=(0.0, 0.0, 0.0), I=(20.0, 20.0, 24.0),
                     cone_angle=30.0, cone_delta=5.0)
    b.add_distant_light(from_p=(1.0, 2.0, 1.5), to=(0, 0, 0), L=(0.8, 0.7, 0.6))
    return b


def fog_build(b):
    """A matte floor and a quad area light in a scattering homogeneous
    medium (sigma_a 0.05, sigma_s 0.1, g 0.3) that holds the camera."""
    m = b.add_matte(kd=(0.6,) * 3)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-20, 0, -20], [20, 0, -20], [20, 0, 20], [-20, 0, 20]], material=m)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-1, 4, -1], [-1, 4, 1], [1, 4, 1], [1, 4, -1]],
                        material=b.add_matte(kd=(0, 0, 0)),
                        area_light=dict(L=(8.0,) * 3, two_sided=True))
    b.camera_medium = b.add_medium(sigma_a=(0.05,) * 3, sigma_s=(0.1,) * 3, g=0.3)
    return b


def scene_of(name: str, pkg: str, res: int = RES, device="cpu"):
    """(scene, camera) of a test scene from the port ("torch", on device)
    or the JAX package ("jax"): "cornell", "furnace" (presets), "delta",
    "fog" (homogeneous) and "grid" (tests/_volpath.py's heterogeneous grid
    with scattering)."""
    if pkg == "jax":
        from rs_pbrt_tpu.models import cameras as cam
        from rs_pbrt_tpu.scene import presets
        from rs_pbrt_tpu.scene.builder import SceneBuilder
        from rs_pbrt_tpu.utils import transform as tr
        kw, fin = {}, {}
    else:
        from rs_pbrt_tpu_torch.models import cameras as cam
        from rs_pbrt_tpu_torch.scene import presets
        from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
        from rs_pbrt_tpu_torch.utils import transform as tr
        kw, fin = dict(device=device), dict(device=device)
    if name == "cornell":
        return presets.cornell_box(resolution=(res, res), **kw)
    if name == "furnace":
        return presets.furnace_sphere(resolution=(res, res), **kw)
    if name == "delta":
        b, look = delta_build(SceneBuilder(), tr), DELTA_LOOK
    elif name == "fog":
        b, look = fog_build(SceneBuilder()), FOG_LOOK
    else:
        b, look = grid(SceneBuilder(), tr, hetero_density(), sigma_s=0.3, g=0.3), GRID_LOOK
    camera = cam.make_perspective(tr.look_at(*look[:3]), (res, res), fov=look[3], **kw)
    return b.finalize(**fin), camera


def grid_lanes(res: int, spp: int, rect=None):
    """(pix (N, 2) int32, sn (N,)) of spp samples of every pixel of rect
    (px0, px1, py0, py1), the whole film without one: the render's order,
    x fastest, then sample."""
    px0, px1, py0, py1 = rect if rect is not None else (0, res, 0, res)
    xs, ys = np.meshgrid(np.arange(px0, px1), np.arange(py0, py1))
    pix = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1)).astype(np.int32)
    return pix, np.repeat(np.arange(spp), (px1 - px0) * (py1 - py0)).astype(np.int32)


def crop_rect(res: int, crop):
    """The pixel rect of a fractional crop window (render.crop_pixel_rect)."""
    x0, x1, y0, y1 = crop
    px0, py0 = int(np.ceil(res * x0)), int(np.ceil(res * y0))
    return px0, max(int(np.ceil(res * x1)), px0 + 1), py0, max(int(np.ceil(res * y1)), py0 + 1)


SCRIPT = r"""
import os, sys, json, time
import numpy as np
import jax, jax.numpy as jnp
import _bdptscene as B
from rs_pbrt_tpu.models import samplers as jsm
from rs_pbrt_tpu.models.integrators import bdpt as jb, mlt as jm, path as jpa
from rs_pbrt_tpu.ops import film as jfilm
jobs = json.load(open(sys.argv[1]))
inp = dict(np.load(sys.argv[2]))

def save(tag, res):
    np.savez(f"{sys.argv[3]}/part_{tag}.npz", **{tag + ":" + k: np.asarray(v) for k, v in res.items()})
    os.replace(f"{sys.argv[3]}/part_{tag}.npz", f"{sys.argv[3]}/{tag}.npz")

for tag, (kind, opt) in jobs.items():
    t_job = time.time()
    res = {}
    if kind == "lanes":
        scene, camera = B.scene_of(opt["scene"], "jax")
        kind_s = jsm.SOBOL if opt["sampler"] == "sobol" else jsm.RANDOM
        cfg = jsm.make_sampler(kind_s, opt["spp"], (B.RES, B.RES))
        pcfg = jpa.PathCfg(opt["depth"], 1.0)
        def lanes(scene, pix, sn):
            ctx = jsm.make_ctx(cfg, pix, sn)
            pf = pix.astype(jnp.float32) + jsm.get_2d(cfg, ctx, 0)
            return (pf,) + jb.radiance_and_splats(scene, camera, pcfg, cfg, ctx, pf)
        fn = jax.jit(lanes)
        for name, rect in opt["sets"]:
            pix, sn = inp[f"{tag}:{name}:pix"], inp[f"{tag}:{name}:sn"]
            pf, L, sp, sl = fn(scene, jnp.asarray(pix), jnp.asarray(sn.astype(np.uint32)))
            spp = int(inp[f"{tag}:{name}:spp"])
            film = jfilm.make_film((B.RES, B.RES))
            film = jfilm.add_samples(film, jfilm.make_filter(jfilm.FILTER_BOX), pf, L)
            img = np.asarray(jfilm.to_rgb(jfilm.add_splats(film, sp, sl), splat_scale=1.0 / spp))
            if rect is not None:
                px0, px1, py0, py1 = rect
                out = np.zeros_like(img)
                out[py0:py1, px0:px1] = img[py0:py1, px0:px1]
                img = out
            res.update({f"{name}:pf": pf, f"{name}:L": L, f"{name}:sp": sp, f"{name}:sl": sl,
                        f"{name}:img": img})
    elif kind == "mlt":
        scene, camera = B.scene_of("cornell", "jax")
        depth, n = opt["depth"], opt["n"]
        pcfg = jpa.PathCfg(depth, 1.0)
        cfg_s = jsm.make_sampler(jsm.RANDOM, 1, (B.RES, B.RES))
        n_pss = jm.n_pss_for_depth(depth)
        key = jax.random.PRNGKey(opt["seed"])
        b, pss, ev, _ = jm._bootstrap_chains(scene, camera, pcfg, cfg_s, None, False, None, n, n,
                                             n_pss, depth, key)
        k, k1 = jax.random.split(key)
        k, k2 = jax.random.split(k)
        res.update(boot=jax.random.uniform(k1, (n, n_pss)), u_pick=jax.random.uniform(k2, (n,)),
                   b=b, pss=pss, **{f"ev{i}": v for i, v in enumerate(ev)})
        step = jax.jit(lambda scene, pss, ev, film, u: jm._mutation_step(
            scene, camera, pcfg, cfg_s, None, False, None, pss, ev, film, u))
        film = jfilm.make_film((B.RES, B.RES))
        for s in range(opt["steps"]):
            u = tuple(jnp.asarray(inp[f"{tag}:u{s}_{k}"]) for k in ("large", "fresh", "noise", "accept"))
            new, ev, film = step(scene, pss, ev, film, u)
            res[f"acc{s}"] = jnp.any(new != pss, -1)
            pss = new
            res[f"pss{s}"] = pss
            res.update({f"ev{s}_{i}": v for i, v in enumerate(ev)})
        res["splat"] = film.splat
    elif kind == "strat":
        scene, camera = B.scene_of("cornell", "jax")
        pcfg = jpa.PathCfg(opt["depth"], 1.0)
        cfg_s = jsm.make_sampler(jsm.RANDOM, 1, (B.RES, B.RES))
        ev = jax.jit(lambda scene, pss: jm._eval_target(scene, camera, pcfg, cfg_s, pss, None, True))(
            scene, jnp.asarray(inp[tag + ":pss"]))
        res.update({f"ev{i}": v for i, v in enumerate(ev)})
    save(tag, res)
    print(f"{tag}: {time.time() - t_job:.1f} s", flush=True)
"""
