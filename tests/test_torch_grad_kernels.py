"""The plain twins of the port's three backward kernels against the JAX
package's reverse-mode AD on the same inputs, made with numpy from seeds:

- G1 (ops/hit_grad_kernel.hit_vjp_plain): jax.vjp of ops/intersect.py
  intersect_tri at each lane's hit triangle, in o, d and the three
  vertices, on seeded rays and triangles, rays whose largest direction
  axis is x, y or z, ties between axes and near-degenerate shears (|d|'s
  largest component barely above the next); and torch.autograd of the
  port's own watertight test (ops/watertight.py, its shear folded into a
  matrix), both in f64, at rtol 1e-9 (the f32 sums of ill-conditioned
  hits differ from the exact ones by up to ~2e-3 in both packages alike).
- T2 (ops/texture_kernel.texture_grad_plain): jax.vjp of
  ops/texture.eval_texture in tex_params and tex_atlas, one case per
  texture type of tools/texture_scenes.py's tables at level 0, and the
  image map and the checker over it through the MIP pyramid at a
  footprint.
- R2 (ops/splat_kernel.splat_grad_plain): jax.vjp of ops/film.add_samples
  in L, one case per filter kind, a NaN sample among them.
Tolerance rtol 1e-5, atol 1e-6 x the largest |g|.  The autograd Functions
that bind them (TriHitFn, TextureFn, SplatFn) give, on the CPU, the
gradient of the plain forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import film as jfilm
from rs_pbrt_tpu.ops import intersect as jis
from rs_pbrt_tpu.ops import texture as jtx
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.ops import film as fm
from rs_pbrt_tpu_torch.ops import hit_grad_kernel as hg
from rs_pbrt_tpu_torch.ops import splat_kernel as rk
from rs_pbrt_tpu_torch.ops import texture as tx
from rs_pbrt_tpu_torch.ops import texture_kernel as tk
from rs_pbrt_tpu_torch.ops import watertight as wt
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import texture_scenes as ts

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6  # atol x the largest |g|
# the twin in f64 against autograd of ops/watertight.py in f64
WATERTIGHT_TOL = (1e-9, 1e-11)
IMAGE_HW = (24, 32)
N_TEX_LANES = 256


def close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(float(np.abs(want).max()),
                                                                    1e-30))


def hit_cases(axis: str, n: int = 512, seed: int = 0):
    """Seeded triangles and rays aimed near their centroids; axis "x", "y"
    or "z" scales that component of d up so it is the largest, "tie" makes
    two components equal, "shear" puts the second largest within 1e-4 of
    the largest."""
    rng = np.random.default_rng(seed)
    p0 = rng.normal(size=(n, 3)).astype(np.float32)
    p1 = (p0 + rng.normal(size=(n, 3))).astype(np.float32)
    p2 = (p0 + rng.normal(size=(n, 3))).astype(np.float32)
    c = (p0 + p1 + p2) / 3
    o = (c + rng.normal(size=(n, 3)) * 5).astype(np.float32)
    d = (c - o + rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    if axis in "xyz":
        k = "xyz".index(axis)
        d[:, k] = np.sign(d[:, k]) * (np.abs(d).max(1) * 1.5 + 0.1)
    elif axis == "tie":
        d[:, 1] = d[:, 0]
    else:
        big = np.abs(d).max(1)
        d[:, 0] = np.sign(d[:, 0]) * big
        d[:, 2] = np.sign(d[:, 2]) * big * np.float32(1 - 1e-4)
    o = (c - d * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32)  # hits in front
    g = rng.normal(size=(3, n)).astype(np.float32)
    return o, d, p0, p1, p2, g


@pytest.mark.parametrize("axis", ["x", "y", "z", "tie", "shear"])
def test_g1_twin_matches_jax_vjp(axis):
    o, d, p0, p1, p2, g = hit_cases(axis)
    n = o.shape[0]
    f = lambda *a: jis.intersect_tri(a[0], a[1], jnp.full(n, 1e30, jnp.float32), *a[2:])[1:]
    hit = np.asarray(jis.intersect_tri(o, d, jnp.full(n, 1e30, jnp.float32), p0, p1, p2)[0])
    assert hit.mean() > 0.5
    _, vjp = jax.vjp(f, o, d, p0, p1, p2)
    want = [np.asarray(x)[hit] for x in vjp(tuple(g))]
    tris = torch.tensor(np.concatenate([p0, p1, p2, np.zeros((n, 23), np.float32)], 1))
    tri = torch.tensor(np.where(hit, np.arange(n), -1).astype(np.int32))
    g_o, g_d, g_v = hg.hit_vjp_plain(torch.tensor(o), torch.tensor(d), tri, *map(torch.tensor, g),
                                     tris, want_verts=True)
    got = [g_o.numpy()[hit], g_d.numpy()[hit]] + [g_v[:, 3 * k:3 * k + 3].numpy()[hit]
                                                  for k in range(3)]
    for a, b in zip(got, want):
        close(a, b)
    assert (g_o.numpy()[~hit] == 0).all() and (g_v.numpy()[~hit] == 0).all()

    # torch.autograd of the port's watertight test, in f64
    f64 = lambda a, **kw: torch.tensor(np.asarray(a, np.float64), **kw)
    ot, dt = f64(o, requires_grad=True), f64(d, requires_grad=True)
    vt = f64(np.concatenate([p0, p1, p2], 1), requires_grad=True)
    rc = wt.ray_constants(tuple(ot.unbind(-1)), tuple(dt.unbind(-1)))
    _, t, b0, b1 = wt.watertight_tri(rc, tuple(vt.T.unbind(0)), f64(np.full(n, 1e30)))
    gt = [f64(x) for x in g]
    ag = torch.autograd.grad((t * gt[0] + b0 * gt[1] + b1 * gt[2]).sum(), [ot, dt, vt])
    twin = hg.hit_vjp_plain(ot.detach(), dt.detach(), tri, *gt, tris.double(), want_verts=True)
    for a, b in zip(twin, ag):
        close(a.numpy()[hit], b.numpy()[hit], *WATERTIGHT_TOL)


def test_tri_hit_fn_matches_autograd_of_plain():
    """TriHitFn (the plain sweep forward, the twin backward) against
    torch.autograd through the plain sweep itself."""
    o, d, p0, p1, p2, g = hit_cases("z", n=64, seed=3)
    T = 16
    tris = torch.tensor(np.concatenate([p0[:T], p1[:T], p2[:T]], 1))
    from rs_pbrt_tpu_torch.ops import intersect_kernel as ik

    def grads(use_fn):
        ot, dt = torch.tensor(o, requires_grad=True), torch.tensor(d, requires_grad=True)
        vt = tris.clone().requires_grad_(True)
        tm = torch.full((64,), 1e30)
        if use_fn:
            h = hg.diff_tri_hit(ot, dt, tm, vt, lambda a, b, c: ik.closest_sweep(a, b, c, vt, T))
        else:
            h = ik.closest_sweep_plain(ot, dt, tm, vt, T)
        gt = [torch.tensor(x) for x in g]
        loss = (torch.where(h.valid, h.t, 0.0) * gt[0] + h.b0 * gt[1] + h.b1 * gt[2]).sum()
        return torch.autograd.grad(loss, [ot, dt, vt]), h.tri

    (a, tri_a), (b, tri_b) = grads(True), grads(False)
    assert torch.equal(tri_a, tri_b) and bool((tri_a >= 0).any())
    for x, y in zip(a, b):
        close(x.numpy(), y.numpy(), 1e-4, 1e-5)


@pytest.fixture(scope="module")
def tex_tables():
    """texture_grid's tables on both packages' builders, its floor image
    at IMAGE_HW."""
    jscene = ts.build(JaxBuilder(), image_hw=IMAGE_HW).finalize()
    pscene = ts.build(SceneBuilder(), image_hw=IMAGE_HW).finalize("cpu")
    return jscene, tx.tables_of(pscene)


TEX_TYPES = {"constant": tx.TEX_CONSTANT, "scale": tx.TEX_SCALE, "mix": tx.TEX_MIX,
             "checker": tx.TEX_CHECKER, "dots": tx.TEX_DOTS, "fbm": tx.TEX_FBM,
             "wrinkled": tx.TEX_WRINKLED, "marble": tx.TEX_MARBLE, "windy": tx.TEX_WINDY,
             "imagemap": tx.TEX_IMAGEMAP, "uv": tx.TEX_UV, "bilerp": tx.TEX_BILERP}


def _reached(tb, ids) -> int:
    """The type bits of textures ids and of their children."""
    kids = tb.child.numpy()[ids].ravel()
    reach = np.concatenate([ids, kids[kids >= 0]])
    return sum(1 << int(t) for t in np.unique(tb.type.numpy()[reach]))


# a footprint changes only the image map's lookup: the types that reach
# one (itself, and the checker over it) take it as a case of their own
T2_CASES = [(name, False) for name in sorted(TEX_TYPES)] + [("checker", True), ("imagemap", True)]


@pytest.mark.parametrize("name,footprint", T2_CASES,
                         ids=[f"{n}-{'mip' if f else 'level0'}" for n, f in T2_CASES])
def test_t2_twin_matches_jax_vjp(name, footprint, tex_tables):
    jscene, tb = tex_tables
    ids_of = np.flatnonzero(tb.type.numpy() == TEX_TYPES[name])
    assert ids_of.size
    rng = np.random.default_rng(TEX_TYPES[name])
    n = N_TEX_LANES
    ids = ids_of[np.arange(n) % ids_of.size].astype(np.int32)
    uv = rng.uniform(-0.2, 1.2, (n, 2)).astype(np.float32)
    p = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    width = rng.uniform(0.0, 0.2, n).astype(np.float32) if footprint else None
    g = rng.normal(size=(n, 3)).astype(np.float32)
    # the JAX evaluation of the families these lanes reach (the others'
    # selects keep nothing on them), as the port's plain version prunes
    js = jscene._replace(tex_kind_flag=np.zeros((jscene.tex_kind_mask & _reached(tb, ids), 0),
                                                np.float32))
    f = lambda tp, ta: jtx.eval_texture(js._replace(tex_params=tp, tex_atlas=ta), ids, uv, p,
                                        width)
    _, vjp = jax.vjp(f, jscene.tex_params, jscene.tex_atlas)
    want_p, want_a = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    t = torch.tensor
    got_p, got_a = tk.texture_grad_plain(tb, t(ids)[None], t(uv), t(p),
                                         None if width is None else t(width), t(g)[None])
    assert np.abs(want_p).max() > 0.0
    close(got_p.numpy(), want_p)
    if np.abs(want_a).max() > 0.0:
        close(got_a.numpy(), want_a)
    else:
        assert float(got_a.abs().max()) == 0.0


def test_texture_fn_matches_autograd_of_plain(tex_tables):
    """TextureFn on the CPU (T1's plain version forward, the twin
    backward) against autograd through the plain evaluation."""
    _, tb = tex_tables
    rng = np.random.default_rng(7)
    n = 64
    ids = torch.tensor(rng.integers(0, tb.type.shape[0], (2, n)).astype(np.int32))
    uv = torch.tensor(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    p = torch.tensor(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(2, n, 3)).astype(np.float32))
    outs = []
    for fn in (tk.texture_eval, tk.plain):
        params = tb.params.clone().requires_grad_(True)
        atlas = tb.atlas.clone().requires_grad_(True)
        out = fn(tb._replace(params=params, atlas=atlas), ids, uv, p)
        outs.append(torch.autograd.grad((out * g).sum(), [params, atlas]))
    for a, b in zip(*outs):
        close(a.numpy(), b.numpy())
    # uv carrying a gradient takes T3's twin (tests/test_torch_grad_a17c.py)
    uvs = [uv.clone().requires_grad_(True) for _ in range(2)]
    g_uv = [torch.autograd.grad((fn(tb, ids, x, p) * g).sum(), [x])[0]
            for fn, x in zip((tk.texture_eval, tk.plain), uvs)]
    close(g_uv[0].numpy(), g_uv[1].numpy())


FILTERS = {"box": (fm.FILTER_BOX, 1.5), "triangle": (fm.FILTER_TRIANGLE, None),
           "gaussian": (fm.FILTER_GAUSSIAN, None), "mitchell": (fm.FILTER_MITCHELL, None),
           "sinc": (fm.FILTER_SINC, None)}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_r2_twin_matches_jax_vjp(name):
    kind, width = FILTERS[name]
    cfg = fm.make_filter(kind, width, width)
    rng = np.random.default_rng(kind)
    h, w, n = 9, 11, 400
    p_film = rng.uniform(-1.0, 12.0, (n, 2)).astype(np.float32)
    L = rng.normal(size=(n, 3)).astype(np.float32)
    L[3, 1] = np.nan
    g = rng.normal(size=(h, w, 3)).astype(np.float32)
    jcfg = jfilm.FilterCfg(*cfg)
    f = lambda Lj: jfilm.add_samples(jfilm.make_film((w, h)), jcfg, jnp.asarray(p_film), Lj).rgb
    _, vjp = jax.vjp(f, jnp.asarray(L))
    (want,) = vjp(jnp.asarray(g))
    got = rk.splat_grad_plain(cfg, torch.tensor(p_film), torch.tensor(L), torch.tensor(g))
    close(got.numpy(), np.asarray(want))
    assert (got[3] == 0).all()
    # SplatFn: R1's plain version forward, the twin backward
    Lt = torch.tensor(L, requires_grad=True)
    rgb, weight = rk.SplatFn.apply(Lt, torch.tensor(p_film), cfg, h, w)
    (g_fn,) = torch.autograd.grad((rgb * torch.tensor(g)).sum(), [Lt])
    assert torch.equal(g_fn, got)
    film = fm.make_film((w, h), "cpu")
    rk.splat_plain(film.rgb, film.weight, cfg, torch.tensor(p_film), torch.tensor(L))
    assert torch.equal(rgb.detach(), film.rgb) and torch.equal(weight, film.weight)
