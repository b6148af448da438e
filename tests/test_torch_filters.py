"""rs_pbrt_tpu_torch's pixel filters and the filter splat (ops/film.py,
R1's plain version ops/splat_kernel.splat_plain) against the JAX package's
ops/film.py, on the same inputs (made with numpy from a seed).

Tolerances: filter_eval within 1e-6 at offsets across and on the edges of
every kind's support (exp and sin round their last bit otherwise in torch
and XLA); footprint and the filter configs equal; add_samples on a 13 x 9
film that already holds sums, with lanes inside, on the edge of and
outside the film and NaN and infinite radiance, rgb and weight within
rtol 1e-5 (atol 1e-6: both add in lane order, tap by tap, but Mitchell's
negative lobes cancel).  csrc/splat.cuh (R1's per-lane math), built for the
host with g++ without FMA contraction: each lane's tap weights within
1e-6 of the plain version's (bit-equal for the box, triangle and Mitchell).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import film as jfilm
from rs_pbrt_tpu_torch.ops import film as fm
from rs_pbrt_tpu_torch.ops import splat_kernel as sk

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parent.parent / "rs_pbrt_tpu_torch" / "csrc"
KINDS = {"box": fm.FILTER_BOX, "triangle": fm.FILTER_TRIANGLE, "gaussian": fm.FILTER_GAUSSIAN,
         "mitchell": fm.FILTER_MITCHELL, "sinc": fm.FILTER_SINC}
# (kind, xwidth, ywidth, extra): the defaults, a wide box, uneven widths
# and the other parameters
CFGS = [("box", None, None, {}), ("box", 1.5, 1.0, {}), ("triangle", None, None, {}),
        ("triangle", 1.25, 2.5, {}), ("gaussian", None, None, {}),
        ("gaussian", 1.5, 2.25, dict(alpha=3.0)), ("mitchell", None, None, {}),
        ("mitchell", 2.5, 1.5, dict(b=0.5, c=0.25)), ("sinc", None, None, {}),
        ("sinc", 3.0, 2.0, dict(tau=2.0))]


def cfgs(i):
    kind, xw, yw, kw = CFGS[i]
    return (fm.make_filter(KINDS[kind], xw, yw, **kw),
            jfilm.make_filter(KINDS[kind], xwidth=xw, ywidth=yw, **kw))


@pytest.mark.parametrize("i", range(len(CFGS)))
def test_filter_cfg_and_footprint(i):
    cfg, jcfg = cfgs(i)
    assert tuple(cfg) == tuple(jcfg)
    assert fm.FilterCfg(*jcfg) == cfg
    assert fm.footprint(cfg) == jfilm.footprint(jcfg)
    assert fm.grid_filter(cfg) == (i == 0)


def offsets(cfg, n=4000, seed=0):
    """Offsets across the support, its edges and their next floats, 0."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-cfg.xwidth - 1, cfg.xwidth + 1, n).astype(np.float32)
    y = rng.uniform(-cfg.ywidth - 1, cfg.ywidth + 1, n).astype(np.float32)
    edges = []
    for w in (cfg.xwidth, cfg.ywidth, 1e-5 * cfg.xwidth, cfg.tau * cfg.xwidth,
              0.5 * cfg.xwidth, 0.0):
        w32 = np.float32(w)
        for v in (w32, -w32, np.nextafter(w32, np.float32(0)), np.nextafter(w32, np.float32(9)),
                  -np.nextafter(w32, np.float32(0)), -np.nextafter(w32, np.float32(9))):
            edges.append(v)
    e = np.asarray(edges, np.float32)
    ex, ey = np.meshgrid(e, e)
    return np.r_[x, ex.ravel()], np.r_[y, ey.ravel()]


@pytest.mark.parametrize("i", range(len(CFGS)))
def test_filter_eval(i):
    cfg, jcfg = cfgs(i)
    x, y = offsets(cfg)
    got = fm.filter_eval(cfg, torch.as_tensor(x), torch.as_tensor(y)).numpy()
    want = np.asarray(jfilm.filter_eval(jcfg, jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (want != 0).mean() > 0.1 and ((want < 0).any() or CFGS[i][0] not in ("mitchell",))


def samples(res, n, seed):
    """Lanes inside, on the edges of and outside a (w, h) film, and a few
    NaN and infinite radiances."""
    w, h = res
    rng = np.random.default_rng(seed)
    p = np.c_[rng.uniform(-3, w + 3, n), rng.uniform(-3, h + 3, n)].astype(np.float32)
    edge = np.asarray([[0, 0], [w, h], [0, h], [w, 0], [0.5, 0.5], [w - 0.5, h - 0.5],
                       [3, 4], [7.5, 2.0], [-0.5, 4.25], [w + 0.5, 1.0]], np.float32)
    p[:len(edge)] = edge
    L = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    L[3, 1] = np.nan
    L[5, 0] = np.inf
    L[11, 2] = -np.inf
    return p, L


@pytest.mark.parametrize("i", range(len(CFGS)))
def test_add_samples(i):
    cfg, jcfg = cfgs(i)
    res = (13, 9)
    p, L = samples(res, 600, seed=i)
    rng = np.random.default_rng(50 + i)
    rgb0 = rng.uniform(0, 1, (9, 13, 3)).astype(np.float32)
    w0 = rng.uniform(0, 4, (9, 13)).astype(np.float32)
    film = fm.Film(torch.as_tensor(rgb0.copy()), torch.as_tensor(w0.copy()))
    out = fm.add_samples(film, cfg, torch.as_tensor(p), torch.as_tensor(L))
    assert out is film
    jf = jfilm.add_samples(jfilm.Film(jnp.asarray(rgb0), jnp.asarray(w0),
                                      jnp.zeros((9, 13, 3), jnp.float32)),
                           jcfg, jnp.asarray(p), jnp.asarray(L))
    np.testing.assert_allclose(film.rgb.numpy(), np.asarray(jf.rgb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(film.weight.numpy(), np.asarray(jf.weight), rtol=1e-5, atol=1e-6)
    assert np.isfinite(film.rgb.numpy()).all()
    assert np.abs(film.weight.numpy() - w0).max() > 0.5


def test_nan_lane_adds_its_weight():
    """A NaN sample adds black radiance and its full filter weight."""
    cfg = fm.make_filter(fm.FILTER_TRIANGLE)
    film = fm.make_film((13, 9), device="cpu")
    fm.add_samples(film, cfg, torch.tensor([[6.5, 4.5]]), torch.tensor([[np.nan, 1.0, 1.0]]))
    assert float(film.rgb.abs().sum()) == 0.0
    assert float(film.weight.sum()) == 16.0  # the triangle's taps: (1 + 2 + 1)^2


def test_splat_checks_arguments():
    cfg = fm.make_filter(fm.FILTER_MITCHELL)
    film = fm.make_film((13, 9), device="cpu")
    p, L = torch.zeros((4, 2)), torch.zeros((4, 3))
    with pytest.raises(ValueError, match="L must"):
        sk.splat(film.rgb, film.weight, cfg, p, L[:, :2])
    with pytest.raises(ValueError, match="footprint"):
        sk.splat(film.rgb, film.weight, fm.make_filter(fm.FILTER_SINC, 8.0, 8.0), p, L)
    with pytest.raises(ValueError, match="rgb"):
        sk.splat(film.rgb[:, :5], film.weight, cfg, p, L)
    with pytest.raises(ValueError, match="box filter"):
        fm.add_samples_grid(film, cfg, L, 1)


def _tap_weights_plain(cfg, p, res):
    """(N, F*F) weights of each lane's taps (dy major), 0 outside the film:
    splat_plain's taps."""
    w, h = res
    return torch.stack([wgt for _, wgt in sk.taps(cfg, torch.as_tensor(p), h, w)], -1).numpy()


def test_splat_host_build_matches_plain(tmp_path):
    """csrc/splat.cuh compiled for the host (g++ -ffp-contract=off): every
    lane's tap weights as R1 forms them (the two axes' factors' product)
    against the plain version's filter_eval at each tap, every kind."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler to build splat.cuh")
    src = tmp_path / "splat_host.cpp"
    src.write_text('#define RS_HD inline\n#include "splat.cuh"\n'
                   'extern "C" void taps(const float* p, int n, int w, int h, int F, int kind, '
                   'const float* c, float* out) {\n'
                   '  for (int i = 0; i < n; ++i) {\n'
                   '    const int x0 = splat::first_tap(p[2 * i], c[splat::kOffX]);\n'
                   '    const int y0 = splat::first_tap(p[2 * i + 1], c[splat::kOffY]);\n'
                   '    for (int k = 0; k < F; ++k) for (int j = 0; j < F; ++j) {\n'
                   '      const int x = x0 + j, y = y0 + k;\n'
                   '      const bool in = x >= 0 && x < w && y >= 0 && y < h;\n'
                   '      out[(i * F + k) * F + j] = in ? splat::factor(kind, c, 0, '
                   'splat::tap_offset(x, p[2 * i])) * splat::factor(kind, c, 1, '
                   'splat::tap_offset(y, p[2 * i + 1])) : 0.0f;\n'
                   '    }\n  }\n}\n')
    lib = tmp_path / "libsplat_host.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(CSRC), str(src), "-o", str(lib)], check=True, timeout=120)
    taps = ctypes.CDLL(str(lib)).taps
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    res = (13, 9)
    for i in range(len(CFGS)):
        cfg, _ = cfgs(i)
        p, _ = samples(res, 2000, seed=100 + i)
        F = fm.footprint(cfg)
        got = np.zeros((p.shape[0], F * F), np.float32)
        consts = sk.filter_consts(cfg)
        taps(ptr(p), p.shape[0], res[0], res[1], F, int(cfg.kind), ptr(consts), ptr(got))
        want = _tap_weights_plain(cfg, p, res)
        if CFGS[i][0] in ("box", "triangle", "mitchell"):
            np.testing.assert_array_equal(got, want, err_msg=str(CFGS[i]))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=str(CFGS[i]))
