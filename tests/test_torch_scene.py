"""rs_pbrt_tpu_torch scene tables against the JAX package's.

The port builds the Cornell box with its own builder, and carries scenes
built by the JAX front ends across with scene_from_numpy; both must give
the JAX package's packed tables (allclose 1e-6, in practice equal), and
the bounce kernel's eligibility (mega_cfg) must be decided as the JAX
package decides it.
"""

import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import pallas_path as jpp
from rs_pbrt_tpu.scene import presets as jpresets
from rs_pbrt_tpu.scene.api import load_pbrt
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.ops import path_kernel as pk
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder

torch.set_num_threads(2)

TABLES = ("tri_attr", "mat_attr", "light_attr", "alight_tri_cdf", "light_power", "world_center")
PBRT_CORNELL = "assets/scenes/cornell_box.pbrt"


def build_hard(builder_cls):
    """The megakernel stress scene of tests/test_pallas.py: two area lights
    of very different power (one two-sided), multi-triangle light ranges,
    a mesh with vertex normals, and a black material.  builder_cls is the
    JAX package's SceneBuilder or the port's; both take the same calls."""
    b = builder_cls()
    gray = b.add_matte(kd=(0.6, 0.55, 0.5))
    black = b.add_matte(kd=(0.0, 0.0, 0.0))
    quad = [[0, 1, 2], [0, 2, 3]]
    b.add_triangle_mesh(quad, [[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], material=gray)
    nrm = np.array([[0.2, 1, 0], [0, 1, 0.2], [-0.2, 1, 0], [0, 1, -0.2]])
    nrm = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    b.add_triangle_mesh(quad, [[-1, 0.5, -1], [1, 0.6, -1], [1, 0.5, 1], [-1, 0.4, 1]],
                        normals=nrm, material=gray)
    b.add_triangle_mesh([[0, 1, 2]], [[-0.5, 1.2, -0.5], [0.5, 1.2, -0.5], [0.0, 1.2, 0.6]],
                        material=black)
    b.add_triangle_mesh(quad, [[-2, 3, -2], [-1, 3, -2], [-1, 3, -1], [-2, 3, -1]],
                        material=black, area_light=dict(L=(12.0, 10.0, 8.0), two_sided=False))
    b.add_triangle_mesh(quad, [[1, 2.5, 1], [2, 2.5, 1], [2, 2.5, 2], [1, 2.5, 2]],
                        material=black, area_light=dict(L=(0.5, 0.8, 1.1), two_sided=True))
    return b


def load_pbrt_cornell(tmp_path, res, spp):
    """The JAX front end's Cornell box (.pbrt) at res x res."""
    txt = open(PBRT_CORNELL).read().replace("[ 500 ]", f"[ {res} ]").replace("[500]", f"[{res}]")
    path = tmp_path / "cornell.pbrt"
    path.write_text(txt)
    return load_pbrt(str(path), {"samples": spp})


def bridge(jscene):
    return sa.scene_from_numpy({k: np.asarray(getattr(jscene, k)) for k in sa.BRIDGE_FIELDS},
                               device="cpu")


def assert_tables_equal(port_scene, jax_scene):
    for k in TABLES:
        got = getattr(port_scene, k).numpy()
        want = np.asarray(getattr(jax_scene, k))
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=k)
    assert port_scene.world_radius == pytest.approx(float(jax_scene.world_radius), rel=1e-6)
    assert port_scene.n_tris == jax_scene.n_tris
    assert port_scene.n_lights == jax_scene.n_lights


@pytest.mark.parametrize("light_scale,boxes", [(1.0, True), (2.5, False)])
def test_cornell_box_tables(light_scale, boxes):
    scene, _ = presets.cornell_box((16, 16), light_scale=light_scale, boxes=boxes, device="cpu")
    jscene, _ = jpresets.cornell_box((16, 16), light_scale=light_scale, boxes=boxes)
    assert_tables_equal(scene, jscene)


def test_builder_hard_scene_tables():
    """Vertex normals, two lights, a two-sided light: the port's builder
    gives the JAX builder's tables."""
    assert_tables_equal(build_hard(SceneBuilder).finalize("cpu"), build_hard(JaxBuilder).finalize())


def test_bridge_hard_scene():
    jscene = build_hard(JaxBuilder).finalize()
    assert_tables_equal(bridge(jscene), jscene)


def test_bridge_pbrt_cornell(tmp_path):
    jscene = load_pbrt_cornell(tmp_path, 20, 4)[0]
    assert_tables_equal(bridge(jscene), jscene)


def _cases(tmp_path):
    return {
        "preset": (presets.cornell_box((8, 8), device="cpu")[0], jpresets.cornell_box((8, 8))[0]),
        "hard": (build_hard(SceneBuilder).finalize("cpu"), build_hard(JaxBuilder).finalize()),
        "pbrt": (bridge(load_pbrt_cornell(tmp_path, 20, 4)[0]), load_pbrt_cornell(tmp_path, 20, 4)[0]),
    }


@pytest.mark.parametrize("case", ["preset", "hard", "pbrt"])
def test_mega_cfg_agrees(case, tmp_path):
    scene, jscene = _cases(tmp_path)[case]
    got, want = pk.mega_cfg(scene), jpp.mega_cfg(jscene)
    assert want is not None
    assert tuple(got) == tuple(want)


def test_mega_cfg_refuses_spheres():
    """Spheres (and a sphere light) take the general path in both packages."""
    jscene = jpresets.spheres_direct((8, 8))[0]
    assert jpp.mega_cfg(jscene) is None
    assert pk.mega_cfg(bridge(jscene)) is None


def test_mega_cfg_refuses_oren_nayar():
    b = SceneBuilder()
    m = b.add_matte(kd=(0.5, 0.5, 0.5), sigma=20.0)
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=m,
                        area_light=dict(L=(1, 1, 1)))
    assert pk.mega_cfg(b.finalize("cpu")) is None
