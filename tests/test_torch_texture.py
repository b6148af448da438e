"""rs_pbrt_tpu_torch's textures (ops/texture.py, T1's plain version, which
ops/texture_kernel.texture_eval runs on CPU tensors) against the JAX
package's ops/texture.py, and T1's per-lane math (csrc/texture.cuh) built
for the host against the plain version.

Tolerances: per lane within 1e-5 of the JAX eval_texture on 4,096 lanes
of seeded ids, uv, p and footprints (the same formulas; XLA's fused
multiply-adds in this process differ in ulps); the host build of
texture.cuh (g++ -ffp-contract=off, the plain version's op order)
bit-equal to the plain version, both with a correctly rounded sine (the
card's sinf and torch's CUDA sin are one function; the host's two are not).
"""

import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import texture as jtx
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.ops import texture as tx
from rs_pbrt_tpu_torch.ops import texture_kernel as tk
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)
N = 4096
CSRC = Path(__file__).resolve().parent.parent / "rs_pbrt_tpu_torch" / "csrc"


def build(b):
    """Every texture type tag, an image map in each wrap mode and every
    combinator over noise, image and constant children."""
    img = np.random.default_rng(1).random((75, 100, 3)).astype(np.float32)
    images = [b.add_texture(tx.TEX_IMAGEMAP, params={tx.TP_WRAP: wrap, tx.TP_SU: 1.7,
                                                     tx.TP_DV: -0.3, tx.TP_GAMMA_SCALE: 0.8},
                            image=img) for wrap in (0, 1, 2)]
    fbm = b.add_texture(tx.TEX_FBM, params={tx.TP_VALUE: (0.5, 0.6, 0.7), tx.TP_OCTAVES: 5,
                                            tx.TP_OMEGA: 0.6},
                        world_to_texture=tr.scale(2.0, 2.0, 2.0))
    wrinkled = b.add_texture(tx.TEX_WRINKLED, params={tx.TP_VALUE: (1, 1, 1), tx.TP_OCTAVES: 8})
    marble = b.add_texture(tx.TEX_MARBLE, params={tx.TP_SCALE_N: 3.0, tx.TP_VARIATION: 0.4,
                                                  tx.TP_OCTAVES: 6, tx.TP_OMEGA: 0.5})
    windy = b.add_texture(tx.TEX_WINDY, params={tx.TP_VALUE: (0.3, 0.4, 0.5)})
    uv = b.add_texture(tx.TEX_UV, params={tx.TP_SU: 3.0, tx.TP_SV: -2.0})
    const = b.add_texture(tx.TEX_CONSTANT, params={tx.TP_VALUE: (0.2, 0.3, 0.4)})
    b.add_texture(tx.TEX_BILERP, params={tx.TP_VALUE: (0.9, 0.3, 0.4)})
    b.add_texture(tx.TEX_SCALE, children=(images[0], fbm))
    b.add_texture(tx.TEX_MIX, params={tx.TP_VALUE: 0.3}, children=(marble, uv))
    checker = b.add_texture(tx.TEX_CHECKER, params={tx.TP_SU: 4, tx.TP_SV: 4},
                            children=(images[1], windy))
    b.add_texture(tx.TEX_DOTS, params={tx.TP_SU: 6, tx.TP_SV: 6}, children=(wrinkled, const))
    b.add_texture(tx.TEX_CHECKER, children=(images[2], checker))  # a combinator child
    m = b.add_matte()
    b.set_material_texture(m, sa.TEX_SLOT_KD, checker)
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=m)
    return b


@pytest.fixture(scope="module")
def scenes():
    return build(JaxBuilder()).finalize(), build(SceneBuilder()).finalize("cpu")


def lanes(n_tex, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_tex, N).astype(np.int32),
            rng.uniform(-2, 3, (N, 2)).astype(np.float32),
            rng.uniform(-5, 5, (N, 3)).astype(np.float32),
            np.exp(rng.uniform(-12, 1, N)).astype(np.float32))


def test_tables_match_the_jax_builder(scenes):
    js, ps = scenes
    for k in sa.TEXTURE_TABLES:
        np.testing.assert_array_equal(getattr(ps, k).numpy(), np.asarray(getattr(js, k)), k)
    assert ps.tex_kind_mask == js.tex_kind_mask == (1 << 12) - 1
    assert ps.tex_slot_mask == js.tex_slot_mask == 1 << sa.TEX_SLOT_KD
    bridged = sa.scene_from_numpy({k: np.asarray(getattr(js, k)) for k in sa.BRIDGE_FIELDS},
                                  "cpu")
    assert bridged.tex_kind_mask == ps.tex_kind_mask
    for k in sa.TEXTURE_TABLES:
        assert torch.equal(getattr(bridged, k), getattr(ps, k)), k


@pytest.mark.parametrize("footprint", [False, True])
def test_eval_texture_matches_jax(scenes, footprint):
    """Every type tag and wrap mode, at level 0 and at seeded footprints."""
    js, ps = scenes
    ids, uv, p, width = lanes(ps.tex_type.shape[0])
    w = width if footprint else None
    got = tx.eval_texture(tx.tables_of(ps), torch.as_tensor(ids), torch.as_tensor(uv),
                          torch.as_tensor(p), None if w is None else torch.as_tensor(w)).numpy()
    want = np.asarray(jtx.eval_texture(js, jnp.asarray(ids), jnp.asarray(uv), jnp.asarray(p),
                                       None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    types = ps.tex_type.numpy()[ids]
    assert set(np.unique(types)) == set(range(12))
    assert (np.abs(got[types == tx.TEX_IMAGEMAP]).sum(-1) > 0).mean() > 0.5


def test_wrapper_rows_and_negative_ids(scenes):
    """The wrapper's (S, N) rows with shared or per-row points equal the
    plain version lane by lane; a negative id gives zeros."""
    _, ps = scenes
    tb = tx.tables_of(ps)
    ids, uv, p, width = (torch.as_tensor(a) for a in lanes(ps.tex_type.shape[0], seed=1))
    rows = torch.stack([ids, torch.flip(ids, [0]), torch.full_like(ids, -1)])
    out = tk.texture_eval(tb, rows, uv, p, width)
    assert out.shape == (3, N, 3)
    for r in range(2):
        assert torch.equal(out[r], tx.eval_texture(tb, rows[r], uv, p, width))
    assert not out[2].any()
    per = tk.texture_eval(tb, rows[:2], torch.stack([uv, uv + 0.25]), torch.stack([p, p * 0.5]))
    assert torch.equal(per[1], tx.eval_texture(tb, rows[1], uv + 0.25, p * 0.5))


def test_kind_mask_prunes(scenes):
    """A family the kind mask lacks reads its TP_VALUE, in both packages; a
    table of one texture and no bound slot has mask 0 (the JAX rule)."""
    js, ps = scenes
    drop = (1 << tx.TEX_FBM) | (1 << tx.TEX_IMAGEMAP)
    mask = ps.tex_kind_mask & ~drop
    tb = tx.tables_of(ps)._replace(kind_mask=mask)
    ids, uv, p, _ = lanes(ps.tex_type.shape[0], seed=2)
    got = tx.eval_texture(tb, torch.as_tensor(ids), torch.as_tensor(uv), torch.as_tensor(p))
    js_m = js._replace(tex_kind_flag=jnp.zeros((mask, 0), jnp.float32))
    want = np.asarray(jtx.eval_texture(js_m, jnp.asarray(ids), jnp.asarray(uv), jnp.asarray(p)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    leaf = np.isin(ps.tex_type.numpy()[ids], (tx.TEX_FBM, tx.TEX_IMAGEMAP))
    np.testing.assert_array_equal(got.numpy()[leaf],
                                  ps.tex_params.numpy()[ids[leaf], tx.TP_VALUE:tx.TP_VALUE + 3])
    for builder, dev in ((JaxBuilder(), None), (SceneBuilder(), "cpu")):
        builder.add_projection_light()
        s = builder.finalize() if dev is None else builder.finalize(dev)
        assert s.tex_kind_mask == 0


@pytest.mark.skipif(shutil.which("g++") is None, reason="no host C++ compiler to build "
                    "texture.cuh")
def test_host_build_of_t1_is_bit_equal(scenes, tmp_path, monkeypatch):
    """csrc/texture.cuh compiled for the host with the plain version's op
    order gives the plain version's bits on every lane, with and without
    footprints (a correctly rounded sine on both sides)."""
    _, ps = scenes
    drv = tmp_path / "drv.cpp"
    drv.write_text(r'''
#include <cmath>
#include <cstdio>
#include <vector>
static inline float sinf_cr(float x) { return (float)std::sin((double)x); }
#define sinf sinf_cr
#define RS_HD inline
#include "texture.cuh"
template <class T> std::vector<T> rd(const char* f) {
  FILE* fp = fopen(f, "rb"); fseek(fp, 0, SEEK_END); long n = ftell(fp); fseek(fp, 0, SEEK_SET);
  std::vector<T> v(n / sizeof(T)); if (fread(v.data(), 1, n, fp) != (size_t)n) return {};
  fclose(fp); return v; }
int main() {
  auto type = rd<int>("type.bin"); auto params = rd<float>("params.bin");
  auto child = rd<int>("child.bin"); auto w2t = rd<float>("w2t.bin");
  auto atlas = rd<float>("atlas.bin"); auto rect = rd<int>("rect.bin"); auto mip = rd<int>("mip.bin");
  auto nlv = rd<int>("nlv.bin"); auto perm = rd<int>("perm.bin"); auto marble = rd<float>("marble.bin");
  auto meta = rd<int>("meta.bin"); auto ids = rd<int>("ids.bin"); auto uv = rd<float>("uv.bin");
  auto p = rd<float>("p.bin"); auto width = rd<float>("width.bin");
  tex::Tables T{type.data(), params.data(), child.data(), w2t.data(), atlas.data(), rect.data(),
                mip.data(), nlv.data(), perm.data(), marble.data(), meta[0], meta[1], meta[2], meta[3]};
  int n = meta[4]; bool ww = meta[5];
  std::vector<float> out(3 * n);
  for (int i = 0; i < n; ++i) {
    float q[3] = {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
    tex::eval_texture(T, ids[i], uv[2 * i], uv[2 * i + 1], q, ww, ww ? width[i] : 0.f, &out[3 * i]);
  }
  FILE* fp = fopen("out.bin", "wb"); fwrite(out.data(), 4, out.size(), fp); fclose(fp);
}
''')
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-I", str(CSRC), str(drv),
                    "-o", str(tmp_path / "drv")], check=True, timeout=120)
    tb = tx.tables_of(ps)
    ids, uv, p, width = lanes(ps.tex_type.shape[0], seed=3)
    ids[::7] = -1
    for k in ("type", "params", "child", "w2t", "atlas", "rect", "mip", "nlv", "perm"):
        getattr(tb, k).numpy().tofile(tmp_path / f"{k}.bin")
    tx.MARBLE_C.tofile(tmp_path / "marble.bin")
    for name, a in (("ids", ids), ("uv", uv), ("p", p), ("width", width)):
        a.tofile(tmp_path / f"{name}.bin")
    monkeypatch.setattr(torch, "sin", lambda x: torch.as_tensor(
        np.sin(x.numpy().astype(np.float64)).astype(np.float32)))
    for ww in (0, 1):
        np.asarray([tb.type.shape[0], tb.atlas.shape[0], tb.atlas.shape[1], tb.kind_mask, N, ww],
                   np.int32).tofile(tmp_path / "meta.bin")
        subprocess.run([str(tmp_path / "drv")], check=True, cwd=tmp_path, timeout=120)
        got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(N, 3)
        want = tx.eval_texture(tb, torch.as_tensor(ids), torch.as_tensor(uv), torch.as_tensor(p),
                               torch.as_tensor(width) if ww else None).numpy()
        np.testing.assert_array_equal(got, want)
