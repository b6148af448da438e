"""Shared set-up of the port's gradient and checkpoint tests: the scenes as
calls on either package's builder, and the JAX package's results computed
in subprocesses whose XLA contracts no FMAs
(XLA_FLAGS=--xla_cpu_max_isa=SSE4_2), through ``_a25scene.JaxJobs`` with
this module's program.  Each job compiles one value_and_grad (or one
render) and writes its results as it ends, so the port's side of a file
runs while JAX compiles.

Jobs (kind, options); results land in the job's npz under "tag:name":
- "grad": diff/grad.grad_loss of the mean of the image of options scene
  ("cornell", "atlas" or "value"; res, spp, depth): "loss", the scene's
  DiffParams ("p_<field>") and the gradient ("g_<field>").
- "camera": grad_loss_wrt_camera of the mean on the Cornell box (res,
  spp, depth), or with subdiv on the statue of that many subdivisions
  (no accelerator: the dense sweep, which JAX differentiates): "loss",
  "g_cam_to_world", "g_raster_to_camera".
- "edge": edge_boundary_grad on the lit quad (res, spp, spe, seed):
  "boundary"; with "box": grad_loss_wrt_translation of the image's mean
  for the Cornell box's short box, raised 2 units (res, spp, spe):
  "interior" and "boundary", the box moving along BOX_DIR.
- "shadow": shadow_boundary_grad of the blocker scene (res, spp, spe):
  "shadow".
- "checkpoint": the Cornell box (res, spp, depth): an uninterrupted
  render "img"; a render of half the samples checkpointed to
  options["jax_ck"]; and a render resumed from the port's checkpoint
  options["port_ck"] to the full samples, "resumed".
"""

import numpy as np

CORNELL = dict(res=8, spp=2, depth=3)
CAMERA = dict(res=8, spp=2, depth=2)
STATUE = dict(res=6, spp=1, depth=1, subdiv=4)  # 5,124 triangles: the port walks its trees
QUAD = dict(res=8, spp=4, depth=1)
EDGE = dict(res=32, spp=4, spe=64, seed=0)
BOX = dict(res=16, spp=4, spe=8)
SHADOW = dict(res=24, spp=4, spe=8)
CK = dict(res=8, spp=4, depth=3)


def quad_build(b, tx, kind):
    """tests/test_grad.py's textured quads on builder b (tx: the package's
    ops/texture): "atlas", a 4x4 image map on kd; "value", a constant
    texture's value on kd.  Lit by a distant light."""
    if kind == "atlas":
        tid = b.add_texture(tx.TEX_IMAGEMAP, {tx.TP_GAMMA_SCALE: 1.0},
                            image=np.full((4, 4, 3), 0.5, np.float32))
        uvs = dict(uvs=[[0, 0], [1, 0], [1, 1], [0, 1]])
    else:
        tid = b.add_texture(tx.TEX_CONSTANT, {tx.TP_VALUE: (0.4, 0.5, 0.6)})
        uvs = {}
    m = b.add_matte()
    b.set_material_texture(m, 0, tid)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], material=m, **uvs)
    b.add_distant_light(from_p=(0, 0, 1), to=(0, 0, 0), L=(2.0,) * 3)
    return b, int(tid)


QUAD_LOOK = ([0, 0, 4], [0, 0, 0], [0, 1, 0], 45.0)


def edge_build(b):
    """tests/test_grad.py's analytic quad: a matte quad lit by a distant
    light."""
    m = b.add_matte(kd=(0.8,) * 3)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], material=m)
    b.add_distant_light(from_p=(0, 0, 1), to=(0, 0, 0), L=(2.0,) * 3)
    return b


EDGE_LOOK = ([0, 0, 8], [0, 0, 0], [0, 1, 0], 30.0)


def shadow_build(b):
    """tests/test_grad.py's floating blocker: a floor, a dark quad at y = 2
    (triangles 2 and 3) and a small two-sided quad light above."""
    floor = b.add_matte(kd=(0.7,) * 3)
    dark = b.add_matte(kd=(0.2,) * 3)
    g = 8.0
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-g, 0, -g], [-g, 0, g], [g, 0, g], [g, 0, -g]], material=floor)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[0.0, 2, -0.6], [0.8, 2, -0.6], [0.8, 2, 0.6], [0.0, 2, 0.6]],
                        material=dark)
    hl = 0.3
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-1 - hl, 4, -hl], [-1 + hl, 4, -hl], [-1 + hl, 4, hl],
                         [-1 - hl, 4, hl]],
                        material=dark, area_light=dict(L=(40.0,) * 3, two_sided=True))
    return b


SHADOW_LOOK = ([1.5, 8.0, 0.0], [1.5, 0.0, 0.0], [0.0, 0.0, 1.0], 30.0)
SHADOW_MASK = slice(2, 4)  # the blocker's triangles
BOX_MASK = slice(10, 20)  # the Cornell box's short box (walls are triangles 0..9)
BOX_DIR = (0.0, 1.0, 0.0)  # up: its top face's hits move toward the light


def half_weights(res, left: bool):
    """Weights 1 / res^2 on the left (or right) half of the raster."""
    w = np.zeros((res, res), np.float32)
    if left:
        w[:, :res // 2] = 1.0 / (res * res)
    else:
        w[:, res // 2:] = 1.0 / (res * res)
    return w


_JAX = r"""
import json, os, sys, time
import numpy as np
import jax.numpy as jnp
import _gradscene as G
from rs_pbrt_tpu.diff import geometry as dgeo
from rs_pbrt_tpu.diff import grad as dg
from rs_pbrt_tpu.models import cameras as cam
from rs_pbrt_tpu.models import samplers as smpl
from rs_pbrt_tpu.models.integrators import render as rdr
from rs_pbrt_tpu.ops import texture as tx
from rs_pbrt_tpu.scene import presets
from rs_pbrt_tpu.scene.builder import SceneBuilder
from rs_pbrt_tpu.utils import transform as tr

jobs = json.load(open(sys.argv[1]))
mean = lambda img: jnp.mean(img)


def setup(o, scene_cam):
    scene, camera = scene_cam
    cfg = rdr.RenderCfg("path", spp=o["spp"], max_depth=o.get("depth", 1), rr_threshold=1.0)
    return scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, o["spp"], camera.resolution)


def look(lk, res):
    eye, at, up, fov = lk
    return cam.make_perspective(tr.look_at(eye, at, up), (res, res), fov=fov)


for tag, (kind, o) in jobs.items():
    t_job = time.time()
    res = {}
    if kind == "grad":
        if o["scene"] == "cornell":
            sc = presets.cornell_box(resolution=(o["res"], o["res"]))
        else:
            b, _ = G.quad_build(SceneBuilder(), tx, o["scene"])
            sc = (b.finalize(), look(G.QUAD_LOOK, o["res"]))
        scene, camera, cfg, scfg = setup(o, sc)
        p = dg.get_params(scene)
        loss, g = dg.grad_loss(scene, camera, cfg, scfg, mean, p)
        res = dict(loss=loss, **{"p_" + k: v for k, v in p._asdict().items()},
                   **{"g_" + k: v for k, v in g._asdict().items()})
    elif kind == "camera":
        if "subdiv" in o:
            from rs_pbrt_tpu.scene import bigscene
            sc = bigscene.statue_scene((o["res"], o["res"]), subdivisions=o["subdiv"])
        else:
            sc = presets.cornell_box(resolution=(o["res"], o["res"]))
        scene, camera, cfg, scfg = setup(o, sc)
        loss, g = dg.grad_loss_wrt_camera(scene, camera, cfg, scfg, mean)
        res = dict(loss=loss, g_cam_to_world=g.cam_to_world, g_raster_to_camera=g.raster_to_camera)
    elif kind == "edge" and not o.get("box"):
        scene, camera, cfg, scfg = setup(o, (G.edge_build(SceneBuilder()).finalize(),
                                             look(G.EDGE_LOOK, o["res"])))
        mask = jnp.ones(scene.n_tris, bool)
        w = jnp.asarray(G.half_weights(o["res"], True))
        res = dict(boundary=dgeo.edge_boundary_grad(scene, camera, cfg, scfg, mask, (1.0, 0.0, 0.0),
                                                    w, samples_per_edge=o["spe"], seed=o["seed"]))
    elif kind == "edge":
        r = o["res"]
        scene, camera, cfg, scfg = setup(o, presets.cornell_box(resolution=(r, r)))
        mask = np.zeros(scene.n_tris, bool)
        mask[G.BOX_MASK] = True
        mask = jnp.asarray(mask)
        scene = dgeo.translate_tris(scene, mask, jnp.asarray([0.0, 2.0, 0.0], jnp.float32))
        w = np.full((r, r), 1.0 / (r * r), np.float32)
        interior, boundary, _ = dgeo.grad_loss_wrt_translation(
            scene, camera, cfg, scfg, mask, G.BOX_DIR, jnp.asarray(w),
            samples_per_edge=o["spe"], seed=0)
        res = dict(interior=interior, boundary=boundary)
    elif kind == "shadow":
        scene, camera, cfg, scfg = setup(o, (G.shadow_build(SceneBuilder()).finalize(),
                                             look(G.SHADOW_LOOK, o["res"])))
        mask = np.zeros(scene.n_tris, bool)
        mask[G.SHADOW_MASK] = True
        w = jnp.asarray(G.half_weights(o["res"], False))
        res = dict(shadow=dgeo.shadow_boundary_grad(scene, camera, cfg, scfg, mask, (1.0, 0.0, 0.0),
                                                    w, samples_per_edge=o["spe"]))
    elif kind == "checkpoint":
        scene, camera, cfg, scfg = setup(o, presets.cornell_box(resolution=(o["res"], o["res"])))
        # batches of half the samples, every render checkpointed (no
        # finalizing batch): the three share one compile
        kw = dict(max_lanes=o["res"] ** 2 * (o["spp"] // 2), checkpoint_every=o["spp"])
        img = rdr.render(scene, camera, cfg, scfg, checkpoint_path=o["jax_ck"] + ".full.npz", **kw)
        half = cfg._replace(spp=o["spp"] // 2)
        rdr.render(scene, camera, half, scfg, checkpoint_path=o["jax_ck"], **kw)
        resumed = rdr.render(scene, camera, cfg, scfg, checkpoint_path=o["port_ck"], **kw)
        res = dict(img=img, resumed=resumed)
    # each job's npz under its final name only once it is whole
    np.savez(f"{sys.argv[3]}/part_{tag}.npz", **{tag + ":" + k: np.asarray(v) for k, v in res.items()})
    os.replace(f"{sys.argv[3]}/part_{tag}.npz", f"{sys.argv[3]}/{tag}.npz")
    print(f"{tag}: {time.time() - t_job:.1f} s", flush=True)
"""


def jax_jobs(tmp_path, *groups: dict):
    """Starts the JAX jobs of a test file, each group of jobs in a
    subprocess of its own (_a25scene's JaxJobs with this module's
    program)."""
    from _a25scene import JaxJobs

    jax = JaxJobs(tmp_path, script=_JAX)
    for jobs in groups:
        jax.start(jobs)
    return jax
