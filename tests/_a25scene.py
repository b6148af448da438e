"""Shared set-up of the port's tests of instancing, object motion and the
kd-tree: the scenes, seeded rays, and the JAX package's results computed
in subprocesses whose XLA contracts no FMAs
(XLA_FLAGS=--xla_cpu_max_isa=SSE4_2), as tests/_texscene.py computes its
lanes.  A file's fixture starts each group of jobs in a subprocess of its
own (``JaxJobs.start``); a subprocess writes each job's results as it
finishes them, so the port's side of the tests runs while JAX compiles
and a test waits only for its own jobs.

A job is (kind, options); its results land in the job's npz under
"tag:name".
Kinds:
- "forest": the JAX forest (instance_scenes.forest_build on the JAX
  builder, FOREST's size), its instance walk on the rays "tag:o", "tag:d",
  "tag:t_max" of the input npz (the candidates, InstanceHit) and its
  scene_intersect and scene_intersect_p on them.
- "kd_build": build_kdtree's arrays on the boxes "tag:bmin", "tag:bmax".
- "kd_walk": kdtree_intersect_tris closest and any hit of rays "tag:o",
  "tag:d", "tag:t_max" over triangles "tag:tris" through the tree built
  from their boxes, or through a tree given as "tag:kd_<field>".
- "anim": _anim_hits of rays "tag:o", "tag:d", "tag:t_max", "tag:time" on
  the scene options["scene"] names ("group0" or "group1", one of
  two_groups' meshes, or "moving"), and scene_intersect_p's occlusion.
- "render": the JAX render of options["scene"] with options["cfg"]
  (integrator, spp, depth, extra, accelerator), at RES; the JAX
  REGEN_LANE_WIDTH set to options["lane_width"] where given.  Its
  accelerator is build_accel's (options["accel"]), or the kd-tree given as
  "tag:kd_<field>" (the port's build, which test_torch_kdtree holds equal
  to the JAX build of the same scene).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

RES = 32
FOREST = dict(subdivisions=2, grid=4, seed=0)  # 16 instances of 320 triangles
KD_SUBDIV = 4  # the kd statue: 5,124 triangles, above the brute-force limit


def two_groups(b, tr, groups=(0, 1)):
    """Two animated meshes on builder b (those of `groups`): an octahedron
    (group 0) that translates and turns 200 degrees about a tilted axis
    (past 180: slerp takes the shorter arc, the quaternions' dot product
    negative), and a tetrahedron (group 1) that grows from scale 0.5 to
    1.5 while it turns 90 degrees about z; and a static floor triangle.
    tr: utils/transform of either package.  The JAX _anim_hits takes one
    group only (its interpolate shapes its output by the lanes' times, (N,
    1), not by the groups: two groups fail to broadcast), so the JAX side
    computes each group on its own."""
    oct_v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     np.float32)
    oct_f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5],
                      [3, 1, 5], [0, 3, 5]])
    tet_v = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float32)
    tet_f = np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]])

    def rot(axis, deg):
        a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
        th = np.deg2rad(deg)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        m = np.eye(4)
        m[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        return m

    def tm(x, y, z):
        m = np.eye(4)
        m[:3, 3] = (x, y, z)
        return m

    mat = b.add_matte(kd=(0.5, 0.5, 0.5))
    if 0 in groups:
        b.add_animated_triangle_mesh(oct_f, oct_v, tr.from_matrix(tm(-1.5, 0, 0)),
                                     tr.from_matrix(tm(-1.0, 0.8, 0.3) @ rot((0.3, 1, 0.2), 200)),
                                     material=mat)
    if 1 in groups:
        b.add_animated_triangle_mesh(
            tet_f, tet_v, tr.from_matrix(tm(1.5, 0, 0) @ np.diag([.5, .5, .5, 1])),
            tr.from_matrix(tm(1.5, 0.2, 0) @ rot((0, 0, 1), 90) @ np.diag([1.5, 1.5, 1.5, 1])),
            material=mat)
    b.add_triangle_mesh([[0, 1, 2]], [[-5, -3, -5], [5, -3, -5], [0, -3, 5]], material=mat)
    return b


_JAX = r"""
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
import _a25scene as A
from rs_pbrt_tpu.models import cameras as jcam, samplers as jsmpl
from rs_pbrt_tpu.models.integrators import regen as jregen, render as jrdr
from rs_pbrt_tpu.ops import instancing as jinst, kdtree as jkd, scene_intersect as jsi
from rs_pbrt_tpu.scene import bigscene as jbig
from rs_pbrt_tpu.scene.builder import SceneBuilder
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu_torch.tools import instance_scenes as isc
from rs_pbrt_tpu_torch.utils import transform as ptr
jobs = json.load(open(sys.argv[1]))
inp = dict(np.load(sys.argv[2]))

def scene_of(name):
    if name == "forest":
        scene = isc.forest_build(SceneBuilder(), **A.FOREST).finalize()
        eye, look, up, fov = isc.forest_view(A.FOREST["grid"])
    elif name == "moving":
        scene = isc.moving_build(SceneBuilder()).finalize()
        eye, look, up, fov = (278, 273, -800), (278, 273, 0), (0, 1, 0), 39.3077
    elif name.startswith("group"):  # one of two_groups' meshes
        return A.two_groups(SceneBuilder(), ptr, (int(name[5:]),)).finalize(), None
    else:  # the kd statue
        scene, camera = jbig.statue_scene((A.RES, A.RES), subdivisions=A.KD_SUBDIV)
        return scene, camera
    return scene, jcam.make_perspective(jtr.look_at(eye, look, up), (A.RES, A.RES), fov=fov)

def rays(tag):
    return [jnp.asarray(inp[tag + ":" + k]) for k in ("o", "d", "t_max")]

def given_tree(tag):  # the kd-tree given as "tag:kd_<field>", or None
    if tag + ":kd_axis" not in inp:
        return None
    f = {k: jnp.asarray(inp[tag + ":kd_" + k]) for k in
         ("axis", "split", "above", "start", "count", "prim_ids", "bmin", "bmax")}
    return jkd.KdTree(leaf_cap=jnp.zeros((int(inp[tag + ":kd_leaf_cap"]), 0)), **f)

isect = jax.jit(lambda s, a, o, d, t: jsi.scene_intersect(s, o, d, t, a))
isect_p = jax.jit(lambda s, a, o, d, t: jsi.scene_intersect_p(s, o, d, t, a))
import time
for tag, (kind, opt) in jobs.items():
    t_job = time.time()
    if kind == "forest":
        scene, _ = scene_of("forest")
        acc = jsi.build_accel(scene)
        o, d, t = rays(tag)
        cand, cand_t = jax.jit(jinst._collect_candidates, static_argnums=4)(o, d, t, acc.inst.top, 4)
        ih = jax.jit(jinst.instance_intersect)(o, d, t, acc.inst, scene.proto_p0, scene.proto_p1,
                                               scene.proto_p2)
        res = dict(cand=cand, cand_t=cand_t, **{"ih_" + k: v for k, v in ih._asdict().items()})
        it = isect(scene, acc, o, d, t)
        res.update({"it_" + k: v for k, v in it._asdict().items()})
        res["occ"] = isect_p(scene, acc, o, d, t)
    elif kind == "kd_build":
        kt = jkd.build_kdtree(inp[tag + ":bmin"], inp[tag + ":bmax"])
        res = {k: v for k, v in kt._asdict().items() if k != "leaf_cap"}
        res["leaf_cap"] = np.int32(kt.leaf_cap.shape[0])
    elif kind == "kd_walk":
        tris = inp[tag + ":tris"]
        kt = given_tree(tag)
        if kt is None:
            p0, p1, p2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
            kt = jkd.build_kdtree(np.minimum(np.minimum(p0, p1), p2),
                                  np.maximum(np.maximum(p0, p1), p2))
        o, d, t = rays(tag)
        p = [jnp.asarray(tris[:, k:k + 3]) for k in (0, 3, 6)]
        walk = jax.jit(jkd.kdtree_intersect_tris, static_argnames="any_hit")
        h = walk(o, d, t, kt, *p)
        a = walk(o, d, t, kt, *p, any_hit=True)
        res = dict(valid=h.valid, t=h.t, tri=h.tri, b0=h.b0, b1=h.b1, any_valid=a.valid,
                   any_t=a.t)
    elif kind == "anim":
        scene, _ = scene_of(opt["scene"])
        o, d, t = rays(tag)
        hits = jax.jit(jsi._anim_hits)(scene, o, d, t, jnp.asarray(inp[tag + ":time"]))
        res = dict(hits)
        res["occ"] = jax.jit(lambda s, o, d, t, tm: jsi.scene_intersect_p(s, o, d, t, None, time=tm))(
            scene, o, d, t, jnp.asarray(inp[tag + ":time"]))
    elif kind == "render":
        scene, camera = scene_of(opt["scene"])
        integ, spp, depth, extra, accel_kind = opt["cfg"]
        kt = given_tree(tag)
        if kt is not None:
            acc = jsi.Accel(kt, None)
        else:
            acc = jsi.build_accel(scene, kind=accel_kind) if opt.get("accel") else None
        if "lane_width" in opt:
            jregen.REGEN_LANE_WIDTH = opt["lane_width"]
        cfg = jrdr.RenderCfg(integ, spp, depth, 1.0, extra=extra)
        res = dict(img=jrdr.render(scene, camera, cfg, jsmpl.make_sampler(jsmpl.SOBOL, spp, (A.RES, A.RES)),
                                   accel=acc))
    # each job's npz under its final name only once it is whole
    np.savez(f"{sys.argv[3]}/part_{tag}.npz", **{tag + ":" + k: np.asarray(v) for k, v in res.items()})
    os.replace(f"{sys.argv[3]}/part_{tag}.npz", f"{sys.argv[3]}/{tag}.npz")
    print(f"{tag}: {time.time() - t_job:.1f} s", flush=True)
"""


class JaxJobs:
    """A test file's JAX jobs: each ``start(jobs, inputs)`` runs its jobs
    in a subprocess of its own, without FMA contraction; ``results(*tags)``
    waits for those jobs (every one without tags) and returns every result
    read so far."""

    def __init__(self, tmp_path: Path):
        self.tmp = Path(tmp_path)
        self.procs, self.owner = [], {}
        self.res, self.read = {}, set()

    def start(self, jobs: dict, inputs: dict = None) -> "JaxJobs":
        k = len(self.procs)
        np.savez(self.tmp / f"in{k}.npz", **(inputs or {}))
        (self.tmp / f"jobs{k}.json").write_text(json.dumps(jobs))
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
                   PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]))
        with open(self.tmp / f"log{k}.txt", "w") as log:
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _JAX, str(self.tmp / f"jobs{k}.json"),
                 str(self.tmp / f"in{k}.npz"), str(self.tmp)], env=env, cwd=ROOT,
                stdout=log, stderr=subprocess.STDOUT))
        self.owner.update({tag: k for tag in jobs})
        return self

    def results(self, *tags) -> dict:
        deadline = time.monotonic() + 900
        for tag in tags or list(self.owner):
            path, k = self.tmp / f"{tag}.npz", self.owner[tag]
            while tag not in self.read and not path.exists():
                if self.procs[k].poll() is not None and not path.exists():
                    log = (self.tmp / f"log{k}.txt").read_text()
                    raise RuntimeError(f"the JAX subprocess failed before {tag}:\n{log[-4000:]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the JAX job {tag} took over 900 s")
                time.sleep(0.05)
            if tag not in self.read:
                self.res.update(np.load(path))
                self.read.add(tag)
        return self.res

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
