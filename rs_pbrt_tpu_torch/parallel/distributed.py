"""Process groups, host meshes and geometry sharding on torch.distributed.

The port of the JAX package's ``parallel/distributed.py``.  JAX runs one
controller over every device; torch.distributed runs one process a rank.
So every rank calls the same function with the same arguments, holds the
whole scene (the scene is replicated, as in the JAX package) and gets back
the whole result.

- ``init_distributed()`` joins the process group that a launcher such as
  ``torchrun`` describes in RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT,
  and returns False, doing nothing, where they are unset.
- ``start_world(device)`` makes sure a process group exists: without one it
  starts a world of one in this process (a HashStore), so that a mesh works
  on one card with no launcher.  NCCL on the card, gloo on the CPU.
- ``make_host_mesh(n_hosts)`` shapes the world into a ("h", "d")
  DeviceMesh: "h" across hosts, "d" across the cards of one host.
  ``parallel/mesh.py`` reduces over every axis of a mesh, so a 1-D and a
  2-D mesh run the same program.
- ``build_geom_shards`` / ``geometry_sharded_intersect``: triangles split
  into contiguous ranges, one a rank of a mesh axis; each rank sweeps its
  range with K3 (``ops/intersect_kernel.closest_sweep``), and the closest
  hits are merged after an all_gather, ties to the lowest global id, as one
  sweep of the whole table orders them.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve
from ..ops.intersect import TriHit

# every process group the package starts waits this long for its peers
TIMEOUT = timedelta(seconds=300)
_INT_MAX = 2 ** 31 - 1
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device) -> str:
    """The collectives' backend for tensors on device: NCCL on the card
    (raises where this PyTorch has none: there is no quiet fallback to gloo
    or the CPU), gloo on the CPU."""
    dev = resolve(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend: a mesh of CUDA devices "
                               "needs it")
        return "nccl"
    if not dist.is_gloo_available():
        raise RuntimeError("torch.distributed has no gloo backend: a mesh of CPU ranks needs it")
    return "gloo"


def _init(dev: torch.device, **kw):
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), timeout=TIMEOUT, **kw)


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None) -> bool:
    """Joins the process group of a multi-process launch.  The arguments
    default from torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT
    (init_method "env://"); returns False, doing nothing, where none of
    them is given, so that a single-process run needs no set-up.  On the
    card each rank takes the card LOCAL_RANK names (device's index without
    one).  True where a group exists already."""
    if dist.is_initialized():
        return True
    if init_method is None and world_size is None and rank is None:
        if not any(k in os.environ for k in _ENV):
            return False
        init_method = "env://"
    dev = resolve(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    kw = dict(init_method=init_method)
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    _init(dev, **kw)
    return True


def start_world(device="cuda") -> torch.device:
    """The resolved device, with a process group to run collectives on it:
    the existing one, else a world of one started in this process.  A
    group whose backend cannot move device's tensors raises."""
    dev = resolve(device)
    if not dist.is_initialized():
        _init(dev, store=dist.HashStore(), rank=0, world_size=1)
    elif dev.type == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("the process group is NCCL's, which moves no CPU tensors")
    return dev


def make_host_mesh(n_hosts: Optional[int] = None, device="cuda"):
    """A ("h", "d") DeviceMesh over the world: n_hosts rows (hosts) of
    world / n_hosts ranks (the cards of a host).  n_hosts defaults to
    WORLD_SIZE / LOCAL_WORLD_SIZE where a launcher set them, else 1; on one
    host, pass it to factor the ranks into simulated hosts (the tests: 4 CPU
    ranks as 2 x 2).  Raises ValueError where the world does not factor."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = start_world(device)
    n = dist.get_world_size()
    if n_hosts is None:
        n_hosts = max(n // int(os.environ.get("LOCAL_WORLD_SIZE", n)), 1)
    if n_hosts < 1 or n % n_hosts:
        raise ValueError(f"{n} ranks do not factor into {n_hosts} hosts")
    return DeviceMesh(dev.type, torch.arange(n).reshape(n_hosts, n // n_hosts),
                      mesh_dim_names=("h", "d"))


# ---------------------------------------------------------------------------
# primitive-range geometry sharding (for scenes beyond one card's memory)
# ---------------------------------------------------------------------------


class GeomShards(NamedTuple):
    """Host-built triangle shards (leading axis the shard)."""

    p0: np.ndarray  # (G, Ts, 3) padded positions
    p1: np.ndarray
    p2: np.ndarray
    offset: np.ndarray  # (G,) global id of each shard's first triangle
    n_valid: np.ndarray  # (G,) real (unpadded) triangles a shard


def build_geom_shards(p0, p1, p2, n_shards: int) -> GeomShards:
    """Triangles split into contiguous ranges, one a shard.  Padding
    triangles are all zero: det == 0, so they never hit."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    t = p0.shape[0]
    ts = -(-t // n_shards)

    def pad(v):
        out = np.zeros((n_shards * ts, 3), np.float32)
        out[:t] = v
        return out.reshape(n_shards, ts, 3)

    offset = np.arange(n_shards, dtype=np.int32) * ts
    n_valid = np.clip(t - offset, 0, ts).astype(np.int32)
    return GeomShards(pad(p0), pad(p1), pad(p2), offset, n_valid)


def gather(t: torch.Tensor, group) -> torch.Tensor:
    """(G, ...) stack of t from the group's G ranks, in group rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def geometry_sharded_intersect(shards: GeomShards, mesh, axis: str, o, d, t_max) -> TriHit:
    """The closest hit over triangle shards spread on the mesh axis `axis`
    (one shard a rank): each rank sweeps every ray against its range with
    K3, offsets its triangle ids by the range's start, and the (G, R)
    candidates are all_gathered; the winner is the lexicographic (t,
    global id) minimum, so equal t goes to the lowest global id, as in one
    sweep of the whole table.  Returns the same TriHit (global ids) on
    every rank of the axis."""
    from ..ops import intersect_kernel as ik

    group = mesh.get_group(axis)
    g = mesh.get_local_rank(axis)
    if shards.p0.shape[0] != mesh.size(mesh.mesh_dim_names.index(axis)):
        raise ValueError(f"{shards.p0.shape[0]} shards for a mesh axis of "
                         f"{mesh.size(mesh.mesh_dim_names.index(axis))} ranks")
    dev = o.device
    tris = torch.as_tensor(np.concatenate([shards.p0[g], shards.p1[g], shards.p2[g]], 1),
                           device=dev)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    hit = ik.closest_sweep(o, d, t_max, tris, tris.shape[0])
    tri_g = torch.where(hit.valid, hit.tri + int(shards.offset[g]), _INT_MAX)
    t = torch.where(hit.valid, hit.t, 3e38)
    tg, trig = gather(t, group), gather(tri_g, group)
    b0g, b1g = gather(hit.b0, group), gather(hit.b1, group)
    tmin = tg.min(0).values
    tri_w = torch.where(tg <= tmin, trig, _INT_MAX).min(0).values
    win = (trig == tri_w).to(torch.int8).argmax(0)
    r = torch.arange(t.shape[0], device=dev)
    valid = tri_w < _INT_MAX
    return TriHit(valid, torch.where(valid, tmin, t_max), torch.where(valid, tri_w, -1),
                  b0g[win, r], b1g[win, r])
