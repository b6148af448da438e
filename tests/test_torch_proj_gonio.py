"""rs_pbrt_tpu_torch's projection and goniometric lights (models/lights.py
sample_li, sample_le, _angular_map_factors) against the JAX package's:
both lights with seeded images beside a point and an area light, every
field of the light and photon samples; the same lights without an image in
the atlas (a projection light then gives 0, a goniometric light the bare
intensity, lights.py:172-179); and their power, 1e-9 (lights.py:415-433).

Tolerances: per lane within rtol = atol = 1e-5 of the JAX samples (the
same formulas; XLA's fused multiply-adds in this process differ in ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import lights as jlt
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.models import lights as lt
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools.texture_scenes import seeded_image

N = 4096


def _build(b, images: bool):
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        [[-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]],
                        area_light=dict(L=(2.0, 2.0, 2.0)))
    b.add_projection_light(p=(-1.0, 2.0, 1.5), to=(0.0, 0.0, 0.0), I=(5.0, 4.0, 3.0), fov=35.0,
                           image=seeded_image((16, 24), 1) if images else None)
    b.add_gonio_light(p=(1.0, 1.5, -0.5), to=(0.2, -1.0, 0.0), I=(3.0, 3.0, 3.0),
                      image=seeded_image((8, 16), 2) if images else None)
    b.add_point_light(p=(0.0, 2.0, 0.0), I=(1.0, 1.0, 1.0))
    return b


def _scenes(atlas="seeded"):
    """The lights with seeded images, the builder's default (white) ones,
    or with the atlas emptied ("none")."""
    images = atlas == "seeded"
    js, ps = _build(JaxBuilder(), images).finalize(), _build(SceneBuilder(), images).finalize("cpu")
    if atlas == "none":
        js = js._replace(tex_atlas=jnp.zeros((1, 1, 3), jnp.float32))
        ps.tex_atlas = torch.zeros((1, 1, 3))
    return js, ps


def _inputs(seed):
    rng = np.random.default_rng(seed)
    light = rng.integers(0, 4, N).astype(np.int32)
    ref_p = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    return (light, ref_p, rng.uniform(size=(N, 2)).astype(np.float32),
            rng.uniform(size=(N, 2)).astype(np.float32))


def _compare(got, want):
    for name in got._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("atlas", ["seeded", "default", "none"])
def test_sample_li_matches_jax(atlas):
    js, ps = _scenes(atlas)
    assert ps.light_type_mask == js_mask(js)
    light, ref_p, u2, _ = _inputs(1)
    got = lt.sample_li(ps, torch.as_tensor(light), torch.as_tensor(ref_p), torch.as_tensor(u2))
    want = jlt.sample_li(js, jnp.asarray(light), jnp.asarray(ref_p), jnp.asarray(u2))
    _compare(got, want)
    for ltype in (sa.LIGHT_PROJECTION, sa.LIGHT_GONIO):
        on = light == [sa.LIGHT_AREA, sa.LIGHT_PROJECTION, sa.LIGHT_GONIO,
                       sa.LIGHT_POINT].index(ltype)
        li = got.li.numpy()[on]
        assert got.is_delta.numpy()[on].all() and (got.pdf.numpy()[on] == 1).all()
        if atlas == "none" and ltype == sa.LIGHT_PROJECTION:
            assert (li == 0).all()
        elif ltype == sa.LIGHT_PROJECTION:
            assert 0.05 < (li > 0).any(-1).mean() < 0.95  # the window cuts some lanes off
        else:
            assert (li > 0).all()


def js_mask(js):
    return sa.type_mask(np.asarray(js.light_type))


@pytest.mark.parametrize("atlas", ["seeded", "default", "none"])
def test_sample_le_matches_jax(atlas):
    js, ps = _scenes(atlas)
    light, _, u_pos, u_dir = _inputs(2)
    got = lt.sample_le(ps, torch.as_tensor(light), torch.as_tensor(u_pos),
                       torch.as_tensor(u_dir))
    want = jlt.sample_le(js, jnp.asarray(light), jnp.asarray(u_pos), jnp.asarray(u_dir))
    _compare(got, want)
    proj = light == 1
    # projection photons leave inside the window's cone about the light's axis
    axis = np.asarray([1.0, -2.0, -1.5]) / np.linalg.norm([1.0, -2.0, -1.5])
    cos = got.d.numpy()[proj] @ axis
    tan = np.tan(np.deg2rad(35.0) / 2)
    assert (cos >= 1.0 / np.sqrt(1.0 + 2.0 * tan * tan) - 1e-6).all()


def test_power_of_projection_and_goniometric_lights():
    """Neither has a branch in compute_light_power: both get its floor,
    1e-9, in both packages; the flags are a delta position's."""
    js, ps = _scenes()
    np.testing.assert_array_equal(ps.light_power.numpy(), np.asarray(js.light_power))
    assert (ps.light_power.numpy()[1:3] == np.float32(1e-9)).all()
    flags = np.rint(ps.light_attr.numpy()[:, sa.LA_FLAGS])
    assert (flags[1:4] == sa.LF_DELTA_POSITION).all()
