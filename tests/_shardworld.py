"""Shared set-up of tests/test_torch_parallel.py: a world of ranks on the
CPU, the cases every rank runs, and the JAX package's sharded results.

``World.start`` spawns WORLD processes (``python tests/_shardworld.py
<rank> <world> <dir>``), each joining one gloo process group through a
FileStore in dir (no port, so xdist workers cannot collide) with a
timeout of RANK_TIMEOUT.  Every rank runs every case of ``run_cases`` on
the port and writes its results as dir/rank<r>.npz once it has them all;
a rank that raises prints its traceback to its log and exits 1.
``World.results`` waits for every rank against a deadline, kills the
ranks where one failed or the deadline passed, and raises with the
failing rank's log: a rank's exception fails the tests and never hangs
the suite.

The JAX side runs in subprocesses (``_a25scene.JaxJobs`` with SCRIPT) on
a mesh of WORLD of 8 virtual CPU devices (the script adds
``--xla_force_host_platform_device_count=8`` to XLA_FLAGS before JAX
starts).  Jobs: "path" (render_sharded, the box filter), "bdpt", "sppm",
"mlt", "geom" (geometry_sharded_intersect) and "grad" (grad_loss(mesh=)),
at the sizes of tests/test_parallel.py, tests/test_distributed.py and
tests/test_grad.py.
"""

import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

WORLD = 4
RANK_TIMEOUT = 120  # seconds a rank's collective waits for its peers
DEADLINE = 600  # seconds the whole world may take
RES, SPP, DEPTH = (24, 20), 4, 3  # tests/test_parallel.py's Cornell box
CROP = (0.25, 0.75, 0.1, 0.6)
STATUE = dict(res=(24, 16), subdivisions=4, spp=2, depth=3, lane_width=128)
SPPM = dict(n_iterations=2, max_depth=DEPTH)
MLT = dict(mutations_per_pixel=8, max_depth=DEPTH, n_chains=512, n_bootstrap=2048)
GRAD = dict(res=8, spp=2, depth=3)  # tests/_gradscene.py's CORNELL
GEOM = dict(tris=61, rays=256, seed=3)  # tests/test_distributed.py's


def geom_case():
    """(p0, p1, p2, o, d, t_max): tests/test_distributed.py's 61 random
    triangles (an odd count, which pads the shards) and 256 rays."""
    rs = np.random.RandomState(GEOM["seed"])
    nt, nr = GEOM["tris"], GEOM["rays"]
    p0 = rs.uniform(-1, 1, (nt, 3)).astype(np.float32)
    p1 = p0 + rs.uniform(0.05, 0.4, (nt, 3)).astype(np.float32)
    p2 = p0 + rs.uniform(0.05, 0.4, (nt, 3)).astype(np.float32)
    o = rs.uniform(-2, 2, (nr, 3)).astype(np.float32)
    d = rs.normal(size=(nr, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p0, p1, p2, o, d, np.full(nr, 1e30, np.float32)


def port_cases(mesh=None, host_mesh=None, geom_mesh=None) -> dict:
    """Every case on the port, sharded over the meshes given, else on one
    process: name -> numpy array.  The statue's regeneration cases and the
    geometry sharding need their meshes; without them they are left out."""
    import torch

    from rs_pbrt_tpu_torch.diff import grad as dg
    from rs_pbrt_tpu_torch.models import samplers as smpl
    from rs_pbrt_tpu_torch.models.integrators import regen as regenmod
    from rs_pbrt_tpu_torch.models.integrators import render as rdr
    from rs_pbrt_tpu_torch.ops import film as filmmod
    from rs_pbrt_tpu_torch.ops import scene_intersect as si
    from rs_pbrt_tpu_torch.parallel import distributed as pd
    from rs_pbrt_tpu_torch.parallel import mesh as pm
    from rs_pbrt_tpu_torch.scene import bigscene, presets

    out = {}
    scene, camera = presets.cornell_box(RES, device="cpu")
    scfg = smpl.make_sampler(smpl.SOBOL, SPP, RES)
    path = rdr.RenderCfg("path", SPP, DEPTH, 1.0)
    mitchell = filmmod.make_filter(filmmod.FILTER_MITCHELL)
    kw = {} if mesh is None else dict(mesh=mesh)
    out["box"] = rdr.render(scene, camera, path, scfg, **kw)
    out["mitchell"] = rdr.render(scene, camera, path, scfg, filter_cfg=mitchell, **kw)
    out["crop"] = rdr.render(scene, camera, path, scfg, crop=CROP, **kw)
    if host_mesh is not None:
        out["host"] = rdr.render(scene, camera, path, scfg, mesh=host_mesh)
    out["bdpt"] = rdr.render(scene, camera, rdr.RenderCfg("bdpt", SPP, DEPTH, 1.0), scfg, **kw)
    out["sppm"] = rdr.render(scene, camera, rdr.RenderCfg(
        "sppm", SPP, DEPTH, 1.0, extra=dict(n_iterations=SPPM["n_iterations"])), scfg, **kw)
    out["mlt"] = rdr.render(scene, camera, rdr.RenderCfg("mlt", 1, DEPTH, 1.0, extra=dict(
        mutations_per_pixel=MLT["mutations_per_pixel"], chains=MLT["n_chains"],
        bootstrap_samples=MLT["n_bootstrap"])), scfg, **kw)
    g = GRAD
    gscene, gcamera = presets.cornell_box((g["res"], g["res"]), device="cpu")
    loss, grads = dg.grad_loss(gscene, gcamera, rdr.RenderCfg("path", g["spp"], g["depth"], 1.0),
                               smpl.make_sampler(smpl.SOBOL, g["spp"], gcamera.resolution),
                               lambda img: img.mean(), **kw)
    out["grad_loss"] = loss
    out.update({f"grad_{k}": v for k, v in grads._asdict().items()})
    if mesh is not None:
        st = STATUE
        sscene, scamera = bigscene.statue_scene(st["res"], st["subdivisions"], device="cpu")
        accel = si.build_accel(sscene, device="cpu")
        cfg = rdr.RenderCfg("path", st["spp"], st["depth"], 1.0)
        sscfg = smpl.make_sampler(smpl.SOBOL, st["spp"], st["res"])
        old, regenmod.REGEN_LANE_WIDTH = regenmod.REGEN_LANE_WIDTH, st["lane_width"]
        try:
            run = {}
            out["regen_on"] = pm.render_sharded(sscene, scamera, cfg, sscfg, mesh=mesh,
                                                accel=accel, regen=True, stats=run)
            out["regen_iterations"] = np.int64(run["iterations"])
        finally:
            regenmod.REGEN_LANE_WIDTH = old
        out["regen_off"] = pm.render_sharded(sscene, scamera, cfg, sscfg, mesh=mesh, accel=accel)
    if geom_mesh is not None:
        p0, p1, p2, o, d, t_max = geom_case()
        shards = pd.build_geom_shards(p0, p1, p2, geom_mesh.size())
        hit = pd.geometry_sharded_intersect(shards, geom_mesh, "g", torch.as_tensor(o),
                                            torch.as_tensor(d), torch.as_tensor(t_max))
        out.update({f"geom_{k}": v for k, v in hit._asdict().items()})
    return {k: np.asarray(v.detach() if torch.is_tensor(v) else v) for k, v in out.items()}


def rank_main(rank: int, world: int, tmp: Path):
    """One rank of the world: joins the gloo group, runs every case, writes
    rank<r>.npz."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=RANK_TIMEOUT))
    from rs_pbrt_tpu_torch.parallel import distributed as pd
    from rs_pbrt_tpu_torch.parallel import mesh as pm

    res = port_cases(pm.make_mesh("cpu"), pd.make_host_mesh(2, device="cpu"),
                     pm.make_mesh("cpu", axis="g"))
    try:
        pd.make_host_mesh(3, device="cpu")
        res["host3_raised"] = np.bool_(False)
    except ValueError:
        res["host3_raised"] = np.bool_(True)
    res["init_distributed"] = np.bool_(pd.init_distributed("cpu"))
    dist.barrier()
    dist.destroy_process_group()
    np.savez(tmp / f"part{rank}.npz", **res)
    os.replace(tmp / f"part{rank}.npz", tmp / f"rank{rank}.npz")


class World:
    """WORLD ranks of the port on the CPU (see the module's docstring)."""

    def __init__(self, tmp: Path):
        self.tmp = Path(tmp)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]))
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(k, None)
        self.procs = []
        for r in range(WORLD):
            with open(self.tmp / f"log{r}.txt", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(HERE / "_shardworld.py"), str(r), str(WORLD),
                     str(self.tmp)], env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        self.t0 = time.monotonic()
        self.res = None

    def results(self) -> list:
        """Every rank's results (a dict a rank), waiting for them."""
        while self.res is None:
            codes = [p.poll() for p in self.procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.monotonic() - self.t0 > DEADLINE
            if bad or late:
                self.close()
                r = bad[0] if bad else 0
                log = (self.tmp / f"log{r}.txt").read_text()
                why = f"rank {r} exited {codes[r]}" if bad else f"over {DEADLINE} s"
                raise RuntimeError(f"the world of {WORLD} ranks failed ({why}):\n{log[-4000:]}")
            if all(c == 0 for c in codes):
                self.res = [dict(np.load(self.tmp / f"rank{r}.npz")) for r in range(WORLD)]
            else:
                time.sleep(0.05)
        return self.res

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


SCRIPT = r"""
import json, os, sys, time
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
import _shardworld as W
from rs_pbrt_tpu.diff import grad as dg
from rs_pbrt_tpu.models import samplers as smpl
from rs_pbrt_tpu.models.integrators import render as rdr
from rs_pbrt_tpu.parallel import distributed as dist
from rs_pbrt_tpu.parallel import mesh as pmesh
from rs_pbrt_tpu.scene import presets

jobs = json.load(open(sys.argv[1]))
mesh = pmesh.make_mesh(jax.devices()[:W.WORLD])
scene, camera = presets.cornell_box(resolution=W.RES)
scfg = smpl.make_sampler(smpl.SOBOL, W.SPP, W.RES)
for tag, (kind, o) in jobs.items():
    t_job = time.time()
    if kind == "path":
        cfg = rdr.RenderCfg("path", spp=W.SPP, max_depth=W.DEPTH, rr_threshold=1.0)
        res = dict(img=pmesh.render_sharded(scene, camera, cfg, scfg, mesh=mesh))
    elif kind == "bdpt":
        res = dict(img=pmesh.render_bdpt_sharded(scene, camera, spp=W.SPP, max_depth=W.DEPTH,
                                                 sampler_cfg=scfg, mesh=mesh))
    elif kind == "sppm":
        res = dict(img=pmesh.render_sppm_sharded(scene, camera, scfg, mesh=mesh, **W.SPPM))
    elif kind == "mlt":
        res = dict(img=pmesh.render_mlt_sharded(scene, camera, mesh=mesh, **W.MLT))
    elif kind == "geom":
        p0, p1, p2, o_, d, t_max = W.geom_case()
        gmesh = pmesh.make_mesh(jax.devices()[:W.WORLD], axis="g")
        hit = dist.geometry_sharded_intersect(dist.build_geom_shards(p0, p1, p2, W.WORLD), gmesh,
                                              "g", o_, d, t_max)
        res = hit._asdict()
    elif kind == "grad":
        g = W.GRAD
        gscene, gcamera = presets.cornell_box(resolution=(g["res"], g["res"]))
        cfg = rdr.RenderCfg("path", spp=g["spp"], max_depth=g["depth"], rr_threshold=1.0)
        loss, grads = dg.grad_loss(gscene, gcamera, cfg,
                                   smpl.make_sampler(smpl.SOBOL, g["spp"], gcamera.resolution),
                                   lambda img: jnp.mean(img), mesh=mesh)
        res = dict(loss=loss, **grads._asdict())
    np.savez(f"{sys.argv[3]}/part_{tag}.npz", **{tag + ":" + k: np.asarray(v) for k, v in res.items()})
    os.replace(f"{sys.argv[3]}/part_{tag}.npz", f"{sys.argv[3]}/{tag}.npz")
    print(f"{tag}: {time.time() - t_job:.1f} s", flush=True)
"""


if __name__ == "__main__":
    try:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
