"""rs_pbrt_tpu_torch's BDPT (models/integrators/bdpt.py, the W1 wrapper
ops/mis_kernel.py and its per-lane math csrc/mis.cuh, the camera's
importance functions, the film's splat layer) against the JAX package's,
on the same inputs made from a seed.

- W1's plain version against the JAX _mis_weight on seeded subpaths (pdfs
  with zeros and negatives, random delta flags), every strategy at depth
  3, with its endpoint overrides and without: bit-equal (each is a chain
  of single rounded ops on both sides).  csrc/mis.cuh compiled for the
  host without FMA contraction: bit-equal to the plain version on every
  strategy at depth 5.
- camera_we, camera_pdf_we and camera_sample_wi of a perspective and an
  orthographic camera (the pinhole formulas for both) at rtol 1e-5, atol
  1e-6: the inverses of cam_to_world and raster_to_camera are taken in
  f64 on the host once a camera, the JAX package's by jnp.linalg.inv in
  f32 at every call, so they differ by an ulp or so.
- add_splats and to_rgb(splat_scale) at rtol 1e-6 (the scatter-adds sum
  in another order); a film without splats resolves to the same bits as
  before the layer.
- radiance_and_splats per lane (L, splat points, splat values) at rtol =
  atol = 2e-3: the Cornell box (area lights), point, spot and distant
  lights over a mirror sphere (the Sobol' sampler), the furnace sphere
  (the sky), a homogeneous scattering medium and a heterogeneous grid
  medium, each in one batch (grid media key their tracking by lane), the
  JAX side without FMA contraction in subprocesses (tests/_bdptscene.py).
- render.render(RenderCfg("bdpt", ...)) per pixel, and with a crop
  window, against the JAX film functions on those lanes.
"""

import shutil
import subprocess
from collections import namedtuple
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _bdptscene as B
from _a25scene import JaxJobs
from rs_pbrt_tpu.models import cameras as jcam
from rs_pbrt_tpu.models.integrators import bdpt as jbdpt
from rs_pbrt_tpu.ops import film as jfilm
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import bdpt
from rs_pbrt_tpu_torch.models.integrators import path as pathmod
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import film as filmmod
from rs_pbrt_tpu_torch.ops import mis_kernel as misk
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)
# the JAX subprocesses start before the first test, so they compile while
# the tests that need none run
pytestmark = pytest.mark.usefixtures("jax_side")

CSRC = Path(__file__).resolve().parent.parent / "rs_pbrt_tpu_torch" / "csrc"
TOL = 2e-3
# tag: (scene, sampler); the Cornell box's lanes also hold a crop window's
LANE_SCENES = {"cornell": ("cornell", "random"), "furnace": ("furnace", "random"),
               "delta": ("delta", "sobol"), "fog": ("fog", "random"),
               "grid": ("grid", "random")}
GROUPS = (("cornell", "furnace"), ("delta", "fog"), ("grid",))  # a subprocess each
CROP_SPP = 8  # the crop's 16 pixels x 8 samples: the full film's 128 lanes, one compile


def lane_sets(tag: str):
    """[(set name, pixel rect or None, spp)] of a LANE_SCENES entry."""
    sets = [("full", None, B.SPP)]
    if tag == "cornell":
        sets.append(("crop", B.crop_rect(B.RES, B.CROP), CROP_SPP))
    return sets


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    inputs, jobs = {}, {}
    for tag, (scene, sampler) in LANE_SCENES.items():
        for name, rect, spp in lane_sets(tag):
            pix, sn = B.grid_lanes(B.RES, spp, rect)
            inputs.update({f"{tag}:{name}:pix": pix, f"{tag}:{name}:sn": sn,
                           f"{tag}:{name}:spp": np.int32(spp)})
        jobs[tag] = ("lanes", dict(scene=scene, sampler=sampler, spp=B.SPP, depth=B.DEPTH,
                                   sets=[(n, r) for n, r, _ in lane_sets(tag)]))
    jj = JaxJobs(tmp_path_factory.mktemp("bdpt_jax"), B.SCRIPT)
    for group in GROUPS:
        jj.start({t: jobs[t] for t in group}, inputs)
    yield jj
    jj.close()


# ---- W1: the MIS weight ----

def strategies(depth: int):
    """The (s, t) pairs radiance_and_splats connects at max_depth depth."""
    return [(s, t) for t in range(1, depth + 3) for s in range(0, depth + 2)
            if 0 <= s + t - 2 <= depth and (s, t) != (1, 1)]


def seeded_subpaths(rng, n: int, depth: int):
    """(camera, light) columns (pdf_fwd, pdf_rev, delta) of max_depth + 2
    and + 1 vertices, (D, N) numpy: pdfs spanning 1e-3..1e3 with zeros and
    negatives (remap0 maps them to 1), delta on ~20% of the vertices."""
    def side(d):
        pdf = lambda: np.where(rng.uniform(size=(d, n)) < 0.15, rng.choice([0.0, -1.0], (d, n)),
                               10.0 ** rng.uniform(-3, 3, (d, n))).astype(np.float32)
        return pdf(), pdf(), rng.uniform(size=(d, n)) < 0.2
    return side(depth + 2), side(depth + 1)


def strategy_overrides(rng, s: int, t: int, n: int) -> dict:
    """The override keys radiance_and_splats passes strategy (s, t), with
    seeded values: t = 1 the light side's last two pdf_rev; s = 0 the
    camera side's; s = 1 the camera side's and light slot 0's pdf_fwd,
    pdf_rev and delta; else both sides' last two pdf_rev."""
    val = lambda: (10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    if t == 1:
        keys = [("l", s - 1, "pdf_rev")] + ([("l", s - 2, "pdf_rev")] if s >= 2 else [])
    elif s == 0:
        keys = [("c", t - 1, "pdf_rev"), ("c", t - 2, "pdf_rev")]
    elif s == 1:
        keys = [("c", t - 1, "pdf_rev"), ("c", t - 2, "pdf_rev"), ("l", 0, "pdf_fwd"),
                ("l", 0, "pdf_rev")]
    else:
        keys = [("c", t - 1, "pdf_rev"), ("c", t - 2, "pdf_rev"), ("l", s - 1, "pdf_rev"),
                ("l", s - 2, "pdf_rev")]
    ov = {k: val() for k in keys}
    if s == 1 and t > 1:
        ov[("l", 0, "delta")] = rng.uniform(size=n) < 0.3
    return ov


JaxPath = namedtuple("JaxPath", "p pdf_fwd pdf_rev delta")


@pytest.mark.parametrize("s,t", strategies(B.DEPTH))
def test_mis_weight_plain_matches_jax(s, t):
    """W1's plain version is bit-equal to the JAX _mis_weight on strategy
    (s, t), with its overrides and the light origin's delta test, and
    without either."""
    rng = np.random.default_rng(100 * s + t)
    n = 4096
    cam_cols, light_cols = seeded_subpaths(rng, n, B.DEPTH)
    ov = strategy_overrides(rng, s, t, n)
    l0 = rng.uniform(size=n) < 0.25
    jpath = lambda cols: JaxPath(jnp.zeros((n, 1, 3)), *(jnp.asarray(c.T) for c in cols))
    tcols = [torch.as_tensor(c) for c in cam_cols + light_cols]
    for with_ov in (True, False):
        jov = {k: jnp.asarray(v) for k, v in ov.items()} if with_ov else {}
        want = jbdpt._mis_weight(None, jpath(cam_cols), jpath(light_cols), s, t, jov,
                                 l0_is_delta=jnp.asarray(l0) if with_ov else None)
        tov = misk.overrides(s, t, {k: torch.as_tensor(v) for k, v in ov.items()}
                             if with_ov else {})
        got = misk.mis_weight(*tcols, s, t, tov, torch.as_tensor(l0) if with_ov else None)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))


def test_mis_overrides_refuse_other_keys():
    """overrides() maps each endpoint key to its slot and refuses a key the
    strategy's endpoints do not hold."""
    one = torch.ones(3)
    got = misk.overrides(1, 3, {("c", 2, "pdf_rev"): one, ("l", 0, "pdf_rev"): 2 * one})
    assert got[0] is one and torch.equal(got[2], 2 * one) and got[5] is None
    assert misk.overrides(2, 1, {("l", 0, "pdf_rev"): one})[3] is one
    with pytest.raises(ValueError):
        misk.overrides(2, 3, {("c", 0, "pdf_rev"): one})
    with pytest.raises(ValueError):
        misk.overrides(2, 3, {("l", 1, "delta"): one})


@pytest.mark.skipif(shutil.which("g++") is None, reason="no host C++ compiler to build mis.cuh")
def test_host_build_of_w1_is_bit_equal(tmp_path):
    """csrc/mis.cuh compiled for the host without FMA contraction gives the
    plain version's bits on every strategy at depth 5, with overrides."""
    drv = tmp_path / "drv.cpp"
    drv.write_text(r'''
#include <cstdio>
#include <cstdlib>
#include <vector>
#define RS_HD inline
#include "mis.cuh"
template <class T> std::vector<T> rd(const char* f) {
  FILE* fp = fopen(f, "rb"); fseek(fp, 0, SEEK_END); long n = ftell(fp); fseek(fp, 0, SEEK_SET);
  std::vector<T> v(n / sizeof(T)); if (fread(v.data(), 1, n, fp) != (size_t)n) return {};
  fclose(fp); return v; }
int main(int argc, char** argv) {
  int s = atoi(argv[1]), t = atoi(argv[2]), flags = atoi(argv[3]);
  long long n = atoll(argv[4]);
  auto cf = rd<float>("cf.bin"); auto cr = rd<float>("cr.bin"); auto cd = rd<unsigned char>("cd.bin");
  auto lf = rd<float>("lf.bin"); auto lr = rd<float>("lr.bin"); auto ld = rd<unsigned char>("ld.bin");
  auto ov = rd<float>("ov.bin"); auto od = rd<unsigned char>("od.bin"); auto l0 = rd<unsigned char>("l0.bin");
  mis::Columns a{cf.data(), cr.data(), cd.data(), lf.data(), lr.data(), ld.data(), {},
                 (flags >> 6) & 1 ? od.data() : nullptr, (flags >> 7) & 1 ? l0.data() : nullptr,
                 n, s, t};
  for (int k = 0; k < mis::kFloatSlots; ++k) a.ov[k] = (flags >> k) & 1 ? ov.data() + k * n : nullptr;
  std::vector<float> out(n);
  for (long long i = 0; i < n; ++i) out[i] = mis::weight(a, i);
  FILE* fp = fopen("out.bin", "wb"); fwrite(out.data(), 4, out.size(), fp); fclose(fp);
}
''')
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-I", str(CSRC), str(drv),
                    "-o", str(tmp_path / "drv")], check=True, timeout=120)
    rng = np.random.default_rng(5)
    n, depth = 2048, 5
    (cf, cr, cd), (lf, lr, ld) = seeded_subpaths(rng, n, depth)
    for name, a in (("cf", cf), ("cr", cr), ("cd", cd), ("lf", lf), ("lr", lr), ("ld", ld)):
        a.astype(np.uint8 if a.dtype == bool else np.float32).tofile(tmp_path / f"{name}.bin")
    ov_vals = (10.0 ** rng.uniform(-3, 3, (6, n))).astype(np.float32)
    od, l0 = rng.uniform(size=n) < 0.3, rng.uniform(size=n) < 0.25
    ov_vals.tofile(tmp_path / "ov.bin")
    od.astype(np.uint8).tofile(tmp_path / "od.bin")
    l0.astype(np.uint8).tofile(tmp_path / "l0.bin")
    cols = [torch.as_tensor(c) for c in (cf, cr, cd, lf, lr, ld)]
    for s, t in strategies(depth):
        keys = strategy_overrides(np.random.default_rng(0), s, t, 1)
        tov = misk.overrides(s, t, {k: torch.zeros(1) for k in keys})
        flags = sum(1 << k for k, v in enumerate(tov) if v is not None) | (1 << 7)
        ov = tuple(None if v is None else (torch.as_tensor(od) if k == 6 else
                                           torch.as_tensor(ov_vals[k]))
                   for k, v in enumerate(tov))
        subprocess.run([str(tmp_path / "drv"), str(s), str(t), str(flags), str(n)], check=True,
                       cwd=tmp_path, timeout=60)
        got = np.fromfile(tmp_path / "out.bin", np.float32)
        want = misk.mis_weight_plain(*cols, s, t, ov, torch.as_tensor(l0)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                      err_msg=f"(s, t) = ({s}, {t})")


# ---- the camera's importance and the film's splats ----

@pytest.mark.parametrize("kind", ["perspective", "orthographic"])
def test_camera_importance_matches_jax(kind):
    """camera_we, camera_pdf_we and camera_sample_wi against the JAX
    functions on rays from the camera (in and out of the frustum) and on
    points around the scene; both packages use the pinhole formulas for
    every camera type."""
    look = ([1.0, 2.0, -6.0], [0.2, 0.5, 0.0], [0, 1, 0])
    res = (12, 8)
    if kind == "perspective":
        camera = cam.make_perspective(tr.look_at(*look), res, fov=40.0, device="cpu")
        jcamera = jcam.make_perspective(jtr.look_at(*look), res, fov=40.0)
    else:
        camera = cam.make_orthographic(tr.look_at(*look), res, device="cpu")
        jcamera = jcam.make_orthographic(jtr.look_at(*look), res)
    rng = np.random.default_rng(3)
    n = 4096
    fwd = np.asarray(look[1]) - np.asarray(look[0])
    d = fwd / np.linalg.norm(fwd) + rng.normal(0, 0.5, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.tile(np.float32(look[0]), (n, 1))
    ref = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    close = lambda got, want: np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                                         atol=1e-6)
    we, pr, inside = cam.camera_we(camera, torch.as_tensor(o), torch.as_tensor(d))
    jwe, jpr, jinside = jcam.camera_we(jcamera, jnp.asarray(o), jnp.asarray(d))
    # rays on the frustum's edge may fall either side; raster points
    # outside it (behind the camera, a projective divide near 0) are not
    # compared
    both = inside.numpy() & np.asarray(jinside)
    assert (inside.numpy() != np.asarray(jinside)).sum() <= 2 and both.mean() > 0.3
    same = inside.numpy() == np.asarray(jinside)
    close(we.numpy()[same], np.asarray(jwe)[same])
    close(pr.numpy()[both], np.asarray(jpr)[both])
    pos, pdir = cam.camera_pdf_we(camera, torch.as_tensor(o), torch.as_tensor(d))
    jpos, jpdir = jcam.camera_pdf_we(jcamera, jnp.asarray(o), jnp.asarray(d))
    close(pos.numpy(), jpos)
    close(pdir.numpy()[same], np.asarray(jpdir)[same])
    wi, we, pdf, pr, cam_p = cam.camera_sample_wi(camera, torch.as_tensor(ref))
    jwi, jwe, jpdf, jpr, jcam_p = (np.asarray(x) for x in
                                    jcam.camera_sample_wi(jcamera, jnp.asarray(ref)))
    seen = (we.numpy() > 0) & (jwe > 0)
    assert ((we.numpy() > 0) != (jwe > 0)).sum() <= 2
    # the orthographic raster plane lies at z = 0, so the pinhole image
    # area is infinite and We 0 on both sides
    assert seen.mean() > 0.05 if kind == "perspective" else camera.image_area == float("inf")
    for g, w_ in ((wi, jwi), (pdf, jpdf), (cam_p, jcam_p)):
        close(g.numpy(), w_)
    close(we.numpy()[seen], jwe[seen])
    close(pr.numpy()[seen], jpr[seen])


def test_add_splats_and_to_rgb_match_jax():
    """add_splats drops out-of-film points and non-finite values as the JAX
    function does, to_rgb adds the layer times splat_scale, and a film
    without splats resolves to the same bits as the layer's absence."""
    rng = np.random.default_rng(8)
    w, h, n = 13, 9, 5000
    p = rng.uniform(-2, 15, (n, 2)).astype(np.float32)
    p[:100] = -10.0  # the unconnectable lanes' sentinel
    L = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    L[100:120, 1] = np.nan
    L[120:130, 0] = np.inf
    rgb0 = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
    w0 = rng.uniform(0, 3, (h, w)).astype(np.float32)
    w0[0, :4] = 0.0
    film = filmmod.make_film((w, h), "cpu")
    film.rgb += torch.as_tensor(rgb0)
    film.weight += torch.as_tensor(w0)
    plain = filmmod.to_rgb(film)
    wt = torch.as_tensor(w0)[..., None]
    before = torch.where(wt > 0.0, torch.as_tensor(rgb0) / torch.clamp(wt, min=1e-12), 0.0)
    assert torch.equal(plain, before) and not film.splatted
    filmmod.add_splats(film, torch.as_tensor(p), torch.as_tensor(L))
    jf = jfilm.add_splats(jfilm.Film(jnp.asarray(rgb0), jnp.asarray(w0), jnp.zeros((h, w, 3))),
                          jnp.asarray(p), jnp.asarray(L))
    np.testing.assert_allclose(film.splat.numpy(), np.asarray(jf.splat), rtol=1e-6, atol=1e-6)
    for scale in (1.0, 0.125):
        np.testing.assert_allclose(filmmod.to_rgb(film, splat_scale=scale).numpy(),
                                   np.asarray(jfilm.to_rgb(jf, splat_scale=scale)), rtol=1e-6,
                                   atol=1e-6)


# ---- the BDPT estimate ----

def port_lanes(tag: str, name: str, rect, spp: int):
    """The port's radiance_and_splats on a lane set (the JAX job's lanes)."""
    scene_name, sampler = LANE_SCENES[tag]
    scene, camera = B.scene_of(scene_name, "torch")
    kind = smpl.SOBOL if sampler == "sobol" else smpl.RANDOM
    cfg = smpl.make_sampler(kind, B.SPP, (B.RES, B.RES))
    pix, sn = (torch.as_tensor(a.astype(np.int64)) for a in B.grid_lanes(B.RES, spp, rect))
    ctx = smpl.make_ctx(cfg, pix, sn, frame_lt_spp=kind == smpl.SOBOL)
    pf = pix.to(torch.float32) + smpl.get_2d(cfg, ctx, 0)
    return (pf,) + bdpt.radiance_and_splats(scene, camera, pathmod.PathCfg(B.DEPTH, 1.0), cfg,
                                            ctx, pf)


@pytest.mark.parametrize("tag", list(LANE_SCENES))
def test_radiance_and_splats_matches_jax(jax_side, tag):
    """Per lane: the raster points, L, and every t = 1 splat's point and
    value within rtol = atol = 2e-3 of the JAX package's."""
    pf, L, sp, sl = port_lanes(tag, "full", None, B.SPP)
    res = jax_side.results(tag)
    for key, got in (("pf", pf), ("L", L), ("sp", sp), ("sl", sl)):
        want = res[f"{tag}:full:{key}"]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL, err_msg=f"{tag} {key}")
    assert float(L.sum()) > 0.0 and (sp[:, 0] >= 0).any(), "no radiance or no connectable splat"
    if tag == "fog":  # the walks scattered in the medium
        scene, camera = B.scene_of("fog", "torch")
        assert scene.has_media and not scene.has_grid


@pytest.mark.parametrize("name", ["full", "crop"])
def test_render_bdpt_matches_jax(jax_side, name):
    """render.render(RenderCfg("bdpt", ...)) of the Cornell box, the whole
    film or a crop window (pixels outside it black), per pixel within rtol
    = atol = 2e-3 of the JAX film functions on the same lanes, with its
    stats."""
    scene, camera = B.scene_of("cornell", "torch")
    spp = CROP_SPP if name == "crop" else B.SPP
    cfg = rdr.RenderCfg("bdpt", spp, B.DEPTH, 1.0, crop=B.CROP if name == "crop" else None)
    stats = {}
    rdr.check_cfg(cfg)
    img = rdr.render(scene, camera, cfg, smpl.make_sampler(smpl.RANDOM, spp, (B.RES, B.RES)),
                     stats=stats)
    want = jax_side.results("cornell")[f"cornell:{name}:img"]
    np.testing.assert_allclose(img.numpy(), want, rtol=TOL, atol=TOL)
    n_pix = 16 if name == "crop" else B.RES * B.RES
    assert stats["camera_rays"] == n_pix * spp and stats["batches"] == 1
    assert stats["paths_per_s"] > 0 and stats["resolution"] == (B.RES, B.RES)
    if name == "crop":
        px0, px1, py0, py1 = B.crop_rect(B.RES, B.CROP)
        inside = torch.zeros(B.RES, B.RES, dtype=torch.bool)
        inside[py0:py1, px0:px1] = True
        assert (img[~inside] == 0).all() and float(img[inside].sum()) > 0


@pytest.mark.parametrize("kind", [smpl.SOBOL, smpl.RANDOM, smpl.ZEROTWO, smpl.STRATIFIED,
                                  smpl.HALTON, smpl.MAXMIN])
def test_dims_block_equals_the_draws(kind):
    """BDPT's block of dims drawn ahead gives each get_1d and get_2d read
    the value of its own draw, for every sampler kind (the 2D draws at the
    lens, light and walk pairs)."""
    cfg = smpl.make_sampler(kind, 4, (8, 8))
    pix, sn = (torch.as_tensor(a.astype(np.int64)) for a in B.grid_lanes(8, 4))
    ctx = smpl.make_ctx(cfg, pix, sn, frame_lt_spp=True)
    t_max, s_max = B.DEPTH + 2, B.DEPTH + 1
    block = bdpt._draw_dims(cfg, ctx, t_max, s_max, False)
    cam_base, light_base, s1_base = bdpt.dim_bases(t_max, s_max)
    reads = [(2, 1), (3, 2), (20, 1), (21, 2), (23, 2)]
    for base, verts in ((cam_base, t_max), (light_base, s_max)):
        for k in range(verts - 1):
            reads += [(base + 3 * k, 2), (base + 3 * k + 2, 1)]
    reads += [(s1_base + 3 * t + j, w) for t in range(2, t_max + 1) for j, w in ((0, 1), (1, 2))]
    for dim, width in reads:
        draw = smpl.get_1d if width == 1 else smpl.get_2d
        assert torch.equal(draw(cfg, block, dim), draw(cfg, ctx, dim)), (kind, dim)
