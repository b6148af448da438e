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
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.ops import film as filmmod
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|rs_pbrt_tpu)(?!\w)", re.M)


def test_no_jax_imports():
    pkg = ROOT / "rs_pbrt_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py") if "_build" not in f.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")  # _build/ holds what the build writes, not sources
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    assert FORBIDDEN.search("from rs_pbrt_tpu.ops import film") is not None
    assert FORBIDDEN.search("from rs_pbrt_tpu_torch.ops import film") is None


def test_import_loads_no_jax():
    code = ("import sys; import rs_pbrt_tpu_torch.models.integrators.render, "
            "rs_pbrt_tpu_torch.scene.presets, rs_pbrt_tpu_torch.io.image; "
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
    "make_film": lambda: filmmod.make_film((8, 8)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_without_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("preset", ["cornell_box", "spheres_direct"])
def test_cpu_on_request(preset):
    assert devmod.resolve("cpu") == torch.device("cpu")
    scene, camera = getattr(presets, preset)((8, 8), device="cpu")
    assert scene.device.type == camera.device.type == scene.sph_attr.device.type == "cpu"
    assert np.isfinite(scene.tri_attr.numpy()).all()
