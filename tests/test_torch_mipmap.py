"""rs_pbrt_tpu_torch's MIP pyramids (ops/mipmap.py, host numpy) and the
trilinear lookup (ops/texture.trilinear_lookup) against the JAX package's.

Tolerances: the pyramids equal the JAX ones bit for bit (the same numpy);
the lookup per lane within 1e-5 of the JAX trilinear_lookup (XLA's fused
multiply-adds in this process differ in ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import mipmap as jmm
from rs_pbrt_tpu.ops import texture as jtx
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.ops import mipmap as mm
from rs_pbrt_tpu_torch.ops import texture as tx
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder

IMAGE = np.random.default_rng(5).random((75, 100, 3)).astype(np.float32)


@pytest.mark.parametrize("wrap", [0, 1, 2])
def test_build_pyramid_matches_jax(wrap):
    got, want = mm.build_pyramid(IMAGE, wrap), jmm.build_pyramid(IMAGE, wrap)
    assert [lv.shape for lv in got] == [lv.shape for lv in want]
    assert got[0].shape == (128, 128, 3) and got[-1].shape == (1, 1, 3) and len(got) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    first, w = mm._resample_weights(100, 128)
    np.testing.assert_array_equal(w.sum(1) > 0.999, np.ones(128, bool))


def _scenes(wrap):
    def build(b):
        t = b.add_texture(tx.TEX_IMAGEMAP, params={tx.TP_WRAP: wrap}, image=IMAGE)
        m = b.add_matte()
        b.set_material_texture(m, 0, t)
        b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=m)
        return b
    return build(JaxBuilder()).finalize(), build(SceneBuilder()).finalize("cpu")


@pytest.mark.parametrize("wrap", [0, 1, 2])
@pytest.mark.parametrize("width", [0.0, 1.0 / 64, 1.0])
def test_trilinear_lookup_matches_jax(wrap, width):
    js, ps = _scenes(wrap)
    rng = np.random.default_rng(11)
    n = 2048
    u, v = (rng.uniform(-0.5, 1.5, n).astype(np.float32) for _ in range(2))
    wv = np.full(n, width, np.float32)
    ids = np.zeros(n, np.int32)
    got = tx.trilinear_lookup(tx.tables_of(ps), torch.as_tensor(ids).long(), torch.as_tensor(u),
                              torch.as_tensor(v), torch.as_tensor(wv)).numpy()
    want = np.asarray(jtx.trilinear_lookup(js, jnp.asarray(ids), jnp.asarray(u), jnp.asarray(v),
                                           jnp.asarray(wv)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if width == 1.0:  # the last level, one texel (black outside [0, 1] in wrap 2)
        inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) if wrap == 2 else slice(None)
        np.testing.assert_allclose(got[inside], np.broadcast_to(
            mm.build_pyramid(IMAGE, wrap)[-1][0, 0], got[inside].shape), rtol=1e-6)
    if width == 0.0:  # level 0: the bilinear lookup of the finest level
        ref = tx.atlas_lookup(ps.tex_atlas, ps.tex_rect[torch.as_tensor(ids).long()],
                              torch.as_tensor(u), torch.as_tensor(v)).numpy()
        np.testing.assert_array_equal(got, ref)
