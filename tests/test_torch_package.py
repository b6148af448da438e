"""Rules of the rs_pbrt_tpu_torch package itself.

It never imports JAX or the JAX package (chip_smoke.py neither): it is
held against that package only here, in the tests.  Its entry points run
on the card unless the caller asks for the CPU, and raise when there is
no card instead of quietly falling back.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rs_pbrt_tpu_torch import device as devmod
from rs_pbrt_tpu_torch import main as port_main
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.ops import bvh
from rs_pbrt_tpu_torch.ops import film as filmmod
from rs_pbrt_tpu_torch.ops import gather_probe as gp
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.parallel import distributed as pd
from rs_pbrt_tpu_torch.parallel import mesh as pm
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import bigscene
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.api import load_pbrt
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import (bvh_ties, caustic_scenes, env_scenes, hair_scenes,
                                     instance_scenes, material_scenes, sss_scenes)
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# an import statement of JAX or the JAX package, or the same module named
# to __import__ or importlib.import_module
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|rs_pbrt_tpu)(?!\w)"
                       r"|\b(__import__|import_module)\(\s*[\"'](jax|jaxlib|flax|rs_pbrt_tpu)(?!\w)",
                       re.M)


def test_no_jax_imports():
    pkg = ROOT / "rs_pbrt_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py") if "_build" not in f.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")  # _build/ holds what the build writes, not sources
    assert len(files) > 15
    # the chip tools, which import the package of another checkout with --root
    assert {"k1_b2_replay.py", "k2_replay.py", "sweep_replay.py", "probe_replay.py",
            "regen_sweep.py", "op_count.py"} <= {f.name for f in files}
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    assert FORBIDDEN.search("from rs_pbrt_tpu.ops import film") is not None
    assert FORBIDDEN.search("from rs_pbrt_tpu_torch.ops import film") is None


@pytest.mark.parametrize("line,forbidden", [
    ('__import__("jax.numpy", fromlist=["asarray"]).asarray(m)', True),
    ("x = __import__( 'rs_pbrt_tpu.utils.spectrum')", True),
    ('importlib.import_module("jax")', True),
    ("import_module('rs_pbrt_tpu.scene.api')", True),
    ('importlib.import_module("rs_pbrt_tpu_torch.scene.api")', False),
    ('__import__("jaxtyping")', False),
    ("import jax.numpy as jnp", True),
])
def test_forbidden_catches_dynamic_imports(line, forbidden):
    assert (FORBIDDEN.search(line) is not None) == forbidden


def test_import_loads_no_jax():
    code = ("import sys; import rs_pbrt_tpu_torch.models.integrators.render, "
            "rs_pbrt_tpu_torch.scene.presets, rs_pbrt_tpu_torch.io.image, "
            "rs_pbrt_tpu_torch.tools.sweep_replay, rs_pbrt_tpu_torch.tools.k1_b2_replay, "
            "rs_pbrt_tpu_torch.tools.probe_replay, rs_pbrt_tpu_torch.tools.regen_sweep, "
            "rs_pbrt_tpu_torch.models.lightdistrib, rs_pbrt_tpu_torch.models.integrators.sppm, "
            "rs_pbrt_tpu_torch.ops.sppm_kernel, rs_pbrt_tpu_torch.utils.rng, "
            "rs_pbrt_tpu_torch.tools.caustic_scenes, rs_pbrt_tpu_torch.ops.bssrdf, "
            "rs_pbrt_tpu_torch.ops.medium, rs_pbrt_tpu_torch.ops.medium_kernel, "
            "rs_pbrt_tpu_torch.models.integrators.volpath, rs_pbrt_tpu_torch.tools.sss_scenes, "
            "rs_pbrt_tpu_torch.tools.env_scenes, rs_pbrt_tpu_torch.models.integrators.direct, "
            "rs_pbrt_tpu_torch.ops.intersect, rs_pbrt_tpu_torch.ops.sampling, "
            "rs_pbrt_tpu_torch.ops.fourier_kernel, rs_pbrt_tpu_torch.tools.material_scenes, "
            "rs_pbrt_tpu_torch.utils.spectrum, rs_pbrt_tpu_torch.tools.op_count, "
            "rs_pbrt_tpu_torch.ops.splat_kernel, rs_pbrt_tpu_torch.ops.lens_kernel, "
            "rs_pbrt_tpu_torch.models.realistic, rs_pbrt_tpu_torch.utils.animated, "
            "rs_pbrt_tpu_torch.ops.instancing, rs_pbrt_tpu_torch.ops.instance_kernel, "
            "rs_pbrt_tpu_torch.ops.kdtree, rs_pbrt_tpu_torch.ops.kdtree_kernel, "
            "rs_pbrt_tpu_torch.ops.motion_kernel, rs_pbrt_tpu_torch.tools.instance_scenes, "
            "rs_pbrt_tpu_torch.models.integrators.bdpt, rs_pbrt_tpu_torch.models.integrators.mlt, "
            "rs_pbrt_tpu_torch.ops.mis_kernel, rs_pbrt_tpu_torch.diff.grad, "
            "rs_pbrt_tpu_torch.diff.geometry, rs_pbrt_tpu_torch.ops.hit_grad_kernel, "
            "rs_pbrt_tpu_torch.parallel.mesh, rs_pbrt_tpu_torch.parallel.distributed, "
            "rs_pbrt_tpu_torch.main, rs_pbrt_tpu_torch.scene.api, rs_pbrt_tpu_torch.scene.parser, "
            "rs_pbrt_tpu_torch.io.floatfile, rs_pbrt_tpu_torch.io.measured_ss, "
            "rs_pbrt_tpu_torch.io.plyloader, rs_pbrt_tpu_torch.io.subdiv, "
            "rs_pbrt_tpu_torch.io.nurbs, rs_pbrt_tpu_torch.utils.transform; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'rs_pbrt_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


ENTRY_POINTS = {
    "presets.cornell_box": lambda: presets.cornell_box((8, 8)),
    "presets.spheres_direct": lambda: presets.spheres_direct((8, 8)),
    "SceneBuilder.finalize": lambda: SceneBuilder().finalize(),
    "scene_from_numpy": lambda: sa.scene_from_numpy({}),
    "make_perspective": lambda: cam.make_perspective(tr.look_at((0, 0, -1), (0, 0, 0), (0, 1, 0)),
                                                     (8, 8)),
    "make_orthographic": lambda: cam.make_orthographic(
        tr.look_at((0, 0, -1), (0, 0, 0), (0, 1, 0)), (8, 8)),
    "make_environment": lambda: cam.make_environment(
        tr.look_at((0, 0, -1), (0, 0, 0), (0, 1, 0)), (8, 8)),
    "make_realistic": lambda: cam.make_realistic(
        tr.look_at((0, 0, -1), (0, 0, 0), (0, 1, 0)), (8, 8),
        [50.0, 5.0, 1.5, 20.0, -50.0, 45.0, 1.0, 20.0], focus_distance=2.0),
    "make_film": lambda: filmmod.make_film((8, 8)),
    "statue_scene": lambda: bigscene.statue_scene((8, 8), subdivisions=1),
    "build_accel": lambda: si.build_accel(presets.cornell_box((8, 8), device="cpu")[0]),
    # a user reaches the traversal and the probe with tensors made on the
    # default device
    "bvh12_intersect_tris": lambda: bvh.bvh12_intersect_tris(
        *[torch.zeros(1, 3)] * 2, torch.ones(1), *si.accel_from_numpy(np.zeros((1, 128)), 0)),
    "take_rows": lambda: gp.take_rows(*gp.probe_inputs()),
    "bvh_ties.tie_case": lambda: bvh_ties.tie_case(),
    "hair_scenes.hair_patch": lambda: hair_scenes.hair_patch((8, 8)),
    "hair_scenes.fur_patch": lambda: hair_scenes.fur_patch(4, resolution=(8, 8)),
    "caustic_scenes.caustic_only": lambda: caustic_scenes.caustic_only((8, 8)),
    "caustic_scenes.caustic_hair": lambda: caustic_scenes.caustic_hair((8, 8)),
    "sss_scenes.sss_dragonette": lambda: sss_scenes.sss_dragonette((8, 8)),
    "sss_scenes.smoke_dragonette": lambda: sss_scenes.smoke_dragonette(4, resolution=(8, 8)),
    "presets.furnace_sphere": lambda: presets.furnace_sphere((8, 8)),
    "env_scenes.quadric_env": lambda: env_scenes.quadric_env((8, 8), sky_hw=(8, 16)),
    "env_scenes.statue_env": lambda: env_scenes.statue_env((8, 8), subdivisions=1,
                                                           sky_hw=(8, 16)),
    "material_scenes.material_grid": lambda: material_scenes.material_grid(
        (8, 8), sky_hw=(8, 16), n_mu=8),
    "material_scenes.statue_disney": lambda: material_scenes.statue_disney((8, 8),
                                                                           subdivisions=1),
    "instance_scenes.forest_scene": lambda: instance_scenes.forest_scene(
        (8, 8), subdivisions=0, grid=2),
    "instance_scenes.moving_scene": lambda: instance_scenes.moving_scene((8, 8), subdivisions=0),
    "build_instance_accel": lambda: si.build_accel(
        instance_scenes.forest_scene((8, 8), subdivisions=0, grid=2, device="cpu")[0]),
    "build_accel kdtree": lambda: si.build_accel(
        bigscene.statue_scene((8, 8), subdivisions=1, device="cpu")[0], kind="kdtree"),
    "load_pbrt": lambda: load_pbrt(ROOT / "assets" / "scenes" / "cornell_box.pbrt"),
    "main": lambda: port_main.main(["--path", str(ROOT / "assets" / "scenes" / "cornell_box.pbrt")]),
    # a mesh of the card starts no process group without one
    "make_mesh": lambda: pm.make_mesh(),
    "make_host_mesh": lambda: pd.make_host_mesh(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_without_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_cuda_mesh_needs_nccl(monkeypatch):
    """A mesh of CUDA devices takes NCCL, never gloo or the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        pd.backend_for("cuda:0")
    assert pd.backend_for("cpu") == "gloo"
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("preset", ["cornell_box", "spheres_direct"])
def test_cpu_on_request(preset):
    assert devmod.resolve("cpu") == torch.device("cpu")
    scene, camera = getattr(presets, preset)((8, 8), device="cpu")
    assert scene.device.type == camera.device.type == scene.sph_attr.device.type == "cpu"
    assert np.isfinite(scene.tri_attr.numpy()).all()


def test_chip_smoke_names_template_kernels():
    """chip_smoke.py's phase 2 reads each kernel's resources from nvcc's
    -Xptxas -v log; a template kernel is named with its bool arguments, so
    the forms of K1, K2 and B1/B2 keep their own lines."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    log = "\n".join([
        "ptxas info    : Function properties for _ZN37_INTERNAL_0a_GLOBAL__N__0f3a2b1c_8_bvh12"
        "_cu_1a2b3c4d11walk_kernelILb1EEEvPKfS2_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, 12 bytes smem, 400 bytes cmem[0]",
        "ptxas info    : Function properties for _ZN_GLOBAL__N__0f3a2b1c_8_bounce_cu_1a2b3c4d13"
        "bounce_kernelILb0ELb1EEEvv",
        "    136 bytes stack frame",
        "ptxas info    : Used 80 registers, 5696 bytes smem",
        "ptxas info    : Function properties for _ZN_GLOBAL__N__0f3a2b1c_8_gather_probe_cu_"
        "1a2b3c4d9take_rowsEPKf",
        "ptxas info    : Used 16 registers",
        "ptxas info    : Function properties for _ZN37_INTERNAL_0a_GLOBAL__N__0f3a2b1c_15_gather"
        "_probe_cu_1a2b3c4d16take_loop_kernelILb1EEEvPKfPKiiiNS_4JumpENS_5MagicEPf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 38 registers, 4096 bytes smem, 456 bytes cmem[0]",
        # the namespace's hash is any 8 characters: here they spell rs_splat
        "ptxas info    : Function properties for _ZN40_GLOBAL__N__bcaa1e35_8_splat_cu_rs_splat12"
        "splat_kernelENS_4ArgsE",
        "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 118 registers, used 0 barriers, 32 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__efb7b36d_9_kdtree_cu_7326db82"
        "9kd_kernelILb1EEEvNS_4ArgsE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN41_GLOBAL__N__efb7b36d_9_kdtree_cu_7326db82"
        "9kd_kernelILb1EEEvNS_4ArgsE",
        "    816 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers, 816 bytes cumulative stack size",
    ])
    assert chip_smoke.ptxas_resources(log) == [
        ("bvh12.cu", "walk_kernel<true>", 56, 12, 0),
        ("bounce.cu", "bounce_kernel<false, true>", 80, 5696, 136),
        ("gather_probe.cu", "take_rows", 16, 0, 0),
        ("gather_probe.cu", "take_loop_kernel<true>", 38, 4096, 0),
        ("splat.cu", "splat_kernel", 118, 0, 32),
        ("kdtree.cu", "kd_kernel<true>", 40, 0, 816)]
