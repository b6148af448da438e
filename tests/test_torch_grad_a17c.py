"""Camera gradients through textures, the realistic lens, moving meshes,
curves and grid media (ROADMAP A17c, part 1): the port's backward kernels'
twins against the JAX package's reverse-mode AD lane by lane, and
grad_loss_wrt_camera on five scenes.

Lane level, each twin against jax.vjp of the JAX function on the same
inputs, made with numpy from seeds, in a subprocess whose XLA contracts no
FMAs (tests/_a25scene.JaxJobs), at rtol 1e-5, atol 1e-6 x the largest |g|
(T3's and C5's 2e-6 x, T3_ATOL):

- T3 (ops/texture_kernel.texture_coord_grad_plain, the kernel's sweep term
  by term, as are C5's and M3's twins): eval_texture in uv, p
  and width, one case per texture type of tools/texture_scenes.py's tables
  at level 0, and the image map and the checker over it through the MIP
  pyramid at a footprint;
- C5 (ops/curve_kernel.curve_vjp_plain): curve_seg_test in o and d at the
  hit lanes of cylinder, flat and ribbon segments, from the gradients of t,
  u, v and w;
- M3 (ops/medium_kernel.ratio_track_vjp_plain): _ratio_track_tr in o and
  d on a grid medium; and M1's backward (DeltaTrackFn, one select):
  _delta_track's t in o, d and t_max, with lanes whose t_max is negative
  or 0.

Render level:
- the realistic camera on the Cornell box (4x4, 1 spp, depth 2) and a
  quad moving 0.3 in x under a point light (8x8, 2 spp, depth 1):
  cam_to_world's and raster_to_camera's gradients within rtol 2e-3 (atol
  1e-5 x the largest |g|) of the JAX package's;
- an image-mapped quad (its MIP pyramid read through the camera rays'
  footprints), the hair patch through the curve sweep C3 and through the
  curve tree C1, and the camera in a grid medium with volpath (M1, M2):
  finite, and the translation's y and z within CAM_FD_RTOL of the port's
  own central difference of the loss over the pixels whose samples keep
  their visibility (each closest hit's primitive, each shadow ray's
  occlusion and each delta-tracking collision the same in the base render
  and the four stepped ones), as test_torch_grad.py's camera test holds
  the Cornell box.  C1's gradient equals C3's within rtol 1e-5;
- quadric_env (path, depth 2) and sss_dragonette (volpath, depth 1): the
  camera gradient finite and non-zero (a select's dropped lanes pass no
  NaN through the quadrics, the sky and Fresnel's square roots).
The JAX package's own render-level gradient is NaN on the image-mapped
quad and the hair patch (ROADMAP §C), so those two are held to finite
differences only.
"""

import dataclasses
from contextlib import ExitStack

import numpy as np
import pytest
import torch

from rs_pbrt_tpu_torch.diff import grad as dg
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.models.integrators import volpath as vp
from rs_pbrt_tpu_torch.ops import curve_kernel as ck
from rs_pbrt_tpu_torch.ops import curves as cv
from rs_pbrt_tpu_torch.ops import medium_kernel as mk
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.ops import texture as tx
from rs_pbrt_tpu_torch.ops import texture_kernel as tk
from rs_pbrt_tpu_torch.scene import presets
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import texture_scenes as ts
from rs_pbrt_tpu_torch.utils import transform as tr

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6  # the twins against jax.vjp; atol x the largest |g|
# T3's and C5's atol: the twins sum each term of the hand-derived sweep (a
# noise's 8 corners, a curve hit's frame), JAX the chain of its ops; on a
# lane whose terms are ~100 x its result the two round apart (up to 1.9e-6
# of the largest |g| seen)
T3_ATOL = C5_ATOL = 2e-6
RENDER_RTOL, RENDER_ATOL = 2e-3, 1e-5  # render-level gradients against the JAX package's
CAM_FD_RTOL = 0.08  # test_torch_grad.py's
FD_STEP = 2e-3  # the camera's translation step of the central differences
IMAGE_HW = (24, 32)
N_TEX_LANES = 256
N_CURVE_RAYS = 512
N_MEDIUM_LANES = 256
SINGLET = (50.0, 5.0, 1.5, 20.0, -50.0, 45.0, 1.0, 20.0)  # one lens element
REALISTIC = dict(res=4, spp=1, depth=2)
MOVING = dict(res=8, spp=2, depth=1)
MEAN = lambda img: img.mean()

TEX_TYPES = {"constant": tx.TEX_CONSTANT, "scale": tx.TEX_SCALE, "mix": tx.TEX_MIX,
             "checker": tx.TEX_CHECKER, "dots": tx.TEX_DOTS, "fbm": tx.TEX_FBM,
             "wrinkled": tx.TEX_WRINKLED, "marble": tx.TEX_MARBLE, "windy": tx.TEX_WINDY,
             "imagemap": tx.TEX_IMAGEMAP, "uv": tx.TEX_UV, "bilerp": tx.TEX_BILERP}
# a footprint changes only the image map's lookup: the types that reach
# one (itself, and the checker over it) take it as a case of their own
T3_CASES = [(name, False) for name in sorted(TEX_TYPES)] + [("checker", True), ("imagemap", True)]
CURVE_KINDS = ("cylinder", "flat", "ribbon")

_JAX = r"""
import json, os, sys, time
import numpy as np
import jax
import jax.numpy as jnp
import _volpath as V
from rs_pbrt_tpu.diff import grad as dg
from rs_pbrt_tpu.models import cameras as cam
from rs_pbrt_tpu.models import samplers as smpl
from rs_pbrt_tpu.models.integrators import render as rdr
from rs_pbrt_tpu.models.integrators import volpath as jvp
from rs_pbrt_tpu.ops import curves as jcv
from rs_pbrt_tpu.ops import texture as jtx
from rs_pbrt_tpu.scene import presets
from rs_pbrt_tpu.scene.builder import SceneBuilder
from rs_pbrt_tpu.utils import transform as tr
from rs_pbrt_tpu_torch.tools import texture_scenes as ts

jobs = json.load(open(sys.argv[1]))
inp = dict(np.load(sys.argv[2]))
mean = lambda img: jnp.mean(img)


def out(tag, res):
    np.savez(f"{sys.argv[3]}/part_{tag}.npz", **{tag + ":" + k: np.asarray(v) for k, v in res.items()})
    os.replace(f"{sys.argv[3]}/part_{tag}.npz", f"{sys.argv[3]}/{tag}.npz")


for tag, (kind, o) in jobs.items():
    t_job = time.time()
    res = {}
    if kind == "t3":
        js = ts.build(SceneBuilder(), image_hw=tuple(o["image_hw"])).finalize()
        for case in o["cases"]:
            g = lambda k: inp[case + ":" + k]
            sc = js._replace(tex_kind_flag=np.zeros((int(g("kinds")), 0), np.float32))
            ids = g("ids")
            if g("width").size:
                f = lambda uv, p, w: jtx.eval_texture(sc, ids, uv, p, w)
                args = (g("uv"), g("p"), g("width"))
            else:
                f = lambda uv, p: jtx.eval_texture(sc, ids, uv, p, None)
                args = (g("uv"), g("p"))
            _, vjp = jax.vjp(f, *args)
            for name, v in zip(("uv", "p", "width"), vjp(jnp.asarray(g("g")))):
                res[case + ":" + name] = v
    elif kind == "c5":
        for case in o["cases"]:
            g = lambda k: inp[case + ":" + k]
            s = jcv._gather_seg(jnp.asarray(g("rows")))
            f = lambda oo, dd: jcv.curve_seg_test(oo, dd, jnp.full(oo.shape[0], 1e30, jnp.float32),
                                                 s["cp"], s["w0"], s["w1"], s["u0"], s["u1"],
                                                 s["n0"], s["n1"], s["norm_angle"],
                                                 s["inv_sin_na"], s["ctype"])[1:]
            _, vjp = jax.vjp(f, g("o"), g("d"))
            go, gd = vjp(tuple(jnp.asarray(g("g")[k]) for k in range(4)))
            res[case + ":o"], res[case + ":d"] = go, gd
    elif kind == "medium":
        scene = V.grid(SceneBuilder(), tr, V.hetero_density(), sigma_s=0.5).finalize()
        g = lambda k: inp["medium:" + k]
        mid, in_med, key = g("mid"), g("in_med"), g("key").astype(np.uint32)
        f = lambda oo, dd: jvp._ratio_track_tr(scene, mid, in_med, oo, dd, g("dist"), key,
                                               int(g("salt")), int(g("seed")))
        tr_, vjp = jax.vjp(f, g("o"), g("d"))
        res["tr"] = tr_
        res["ratio_o"], res["ratio_d"] = vjp(jnp.asarray(g("g")))
        f = lambda oo, dd, tm: jvp._delta_track(scene, mid, in_med, oo, dd, tm, key,
                                                np.uint32(int(g("bounce"))), int(g("seed"))).t
        t_, vjp = jax.vjp(f, g("o"), g("d"), g("t_max"))
        res["delta_t"] = t_
        res["delta_o"], res["delta_d"], res["delta_tmax"] = vjp(jnp.asarray(g("g")))
    elif kind == "camera":
        r = o["res"]
        if o["scene"] == "realistic":
            scene, _ = presets.cornell_box(resolution=(r, r))
            camera = cam.make_realistic(tr.look_at((278, 273, -800), (278, 273, 0), (0, 1, 0)),
                                        (r, r), tuple(o["lens"]), aperture_diameter=8.0,
                                        focus_distance=1078.0, film_diag_mm=35.0)
        else:
            b = SceneBuilder()
            m = b.add_matte(kd=(0.8,) * 3)
            b.add_animated_triangle_mesh([[0, 1, 2], [0, 2, 3]], o["quad"], tr.translate((0, 0, 0)),
                                         tr.translate(tuple(o["move"])), material=m)
            b.add_point_light(p=tuple(o["light"]), I=(5.0,) * 3)
            scene = b.finalize()
            camera = cam.make_perspective(tr.look_at(*o["look"][:3]), (r, r), fov=o["look"][3])
        cfg = rdr.RenderCfg("path", spp=o["spp"], max_depth=o["depth"], rr_threshold=1.0)
        loss, g = dg.grad_loss_wrt_camera(scene, camera, cfg,
                                          smpl.make_sampler(smpl.SOBOL, o["spp"], (r, r)), mean)
        res = dict(loss=loss, g_cam_to_world=g.cam_to_world, g_raster_to_camera=g.raster_to_camera)
    out(tag, res)
    print(f"{tag}: {time.time() - t_job:.1f} s", flush=True)
"""

MOVING_QUAD = [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]
MOVING_SCENE = dict(quad=MOVING_QUAD, move=[0.3, 0.0, 0.0], light=[0.5, 0.5, 2.0],
                    look=[[0, 0, 4], [0, 0, 0], [0, 1, 0], 45.0])


def close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(float(np.abs(want).max()),
                                                                    1e-30))


def _reached(tb, ids) -> int:
    """The type bits of textures ids and of their children."""
    kids = tb.child.numpy()[ids].ravel()
    reach = np.concatenate([ids, kids[kids >= 0]])
    return sum(1 << int(t) for t in np.unique(tb.type.numpy()[reach]))


def t3_inputs(tb) -> dict:
    """Per T3 case: the lanes' ids, uv, p, width (empty: none), the
    upstream gradient and the kind bits the JAX evaluation keeps."""
    out = {}
    for name, footprint in T3_CASES:
        case = f"{name}-{'mip' if footprint else 'level0'}"
        ids_of = np.flatnonzero(tb.type.numpy() == TEX_TYPES[name])
        rng = np.random.default_rng(TEX_TYPES[name] + 100 * footprint)
        n = N_TEX_LANES
        ids = ids_of[np.arange(n) % ids_of.size].astype(np.int32)
        vals = dict(ids=ids, uv=rng.uniform(-0.2, 1.2, (n, 2)).astype(np.float32),
                    p=rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32),
                    width=(rng.uniform(0.0, 0.2, n).astype(np.float32) if footprint
                           else np.zeros(0, np.float32)),
                    g=rng.normal(size=(n, 3)).astype(np.float32),
                    kinds=np.asarray(tb.kind_mask & _reached(tb, ids)))
        out.update({f"{case}:{k}": v for k, v in vals.items()})
    return out


def curve_rows(kind: str) -> torch.Tensor:
    """The segment rows of three seeded curves of one kind (a ribbon's
    normals seeded too)."""
    b = SceneBuilder()
    m = b.add_matte()
    rng = np.random.default_rng(CURVE_KINDS.index(kind))
    for _ in range(3):
        kw = dict(normals=rng.normal(size=(2, 3)).astype(np.float32)) if kind == "ribbon" else {}
        b.add_curve(rng.uniform(-1, 1, (4, 3)).astype(np.float32), width0=0.2, width1=0.1,
                    curve_type=kind, splitdepth=1, material=m, **kw)
    return b.finalize("cpu").crv_attr


def c5_inputs() -> dict:
    """Per curve kind: rays aimed near seeded points of its segments, their
    hit segments' rows (the C3 plain sweep's winners), the hit lanes and
    the upstream gradients of t, u, v, w."""
    out = {}
    for kind in CURVE_KINDS:
        rows = curve_rows(kind)
        rng = np.random.default_rng(10 + CURVE_KINDS.index(kind))
        n = N_CURVE_RAYS
        cp = rows[torch.tensor(rng.integers(0, rows.shape[0], n)), :12].reshape(n, 4, 3).numpy()
        w = rng.uniform(0.05, 0.95, (n, 1)).astype(np.float32)
        target = ((1 - w) ** 3 * cp[:, 0] + 3 * w * (1 - w) ** 2 * cp[:, 1]
                  + 3 * w * w * (1 - w) * cp[:, 2] + w ** 3 * cp[:, 3])
        o = (rng.normal(size=(n, 3)) * 3).astype(np.float32)
        d = (target + rng.normal(size=(n, 3)) * 0.02 - o).astype(np.float32)
        h = cv.intersect_curves_plain(torch.tensor(o), torch.tensor(d), torch.full((n,), 1e30),
                                      rows)
        hit = h.valid.numpy()
        vals = dict(o=o[hit], d=d[hit], rows=rows[h.seg[h.valid].long()].numpy(),
                    seg=h.seg[h.valid].numpy(),
                    g=rng.normal(size=(4, int(hit.sum()))).astype(np.float32))
        out.update({f"{kind}:{k}": v for k, v in vals.items()})
    return out


def medium_scene():
    import _volpath as V

    return V.grid(SceneBuilder(), tr, V.hetero_density(), sigma_s=0.5).finalize("cpu")


def medium_inputs() -> dict:
    """Lanes of rays inside the grid medium of tests/_volpath.grid: origins
    in the medium's cube, seeded directions, segment lengths and upstream
    gradients; a tenth of the lanes outside the medium (in_med False) and,
    for M1, a few lanes with t_max -1 and 0."""
    rng = np.random.default_rng(5)
    n = N_MEDIUM_LANES
    o = rng.uniform(-9.0, 9.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = rng.uniform(0.5, 12.0, n).astype(np.float32)
    t_max[:4], t_max[4:8] = -1.0, 0.0
    return {"medium:" + k: v for k, v in dict(
        o=o, d=d, dist=rng.uniform(0.5, 12.0, n).astype(np.float32), t_max=t_max,
        mid=np.zeros(n, np.int32), in_med=rng.uniform(size=n) < 0.9,
        key=np.arange(n, dtype=np.int32), g=rng.normal(size=n).astype(np.float32),
        salt=np.asarray(7), seed=np.asarray(3), bounce=np.asarray(1)).items()}


@pytest.fixture(scope="module")
def tex_tables():
    return tx.tables_of(ts.build(SceneBuilder(), image_hw=IMAGE_HW).finalize("cpu"))


@pytest.fixture(scope="module")
def inputs(tex_tables):
    return {**t3_inputs(tex_tables), **c5_inputs(), **medium_inputs()}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory, inputs):
    from _a25scene import JaxJobs

    jax = JaxJobs(tmp_path_factory.mktemp("a17c"), script=_JAX)
    jax.start({"realistic": ("camera", dict(REALISTIC, scene="realistic", lens=SINGLET)),
               "moving": ("camera", dict(MOVING, scene="moving", **MOVING_SCENE))})
    cases = [f"{n}-{'mip' if f else 'level0'}" for n, f in T3_CASES]
    half = len(cases) // 2
    jax.start({"t3a": ("t3", dict(image_hw=IMAGE_HW, cases=cases[:half])),
               "medium": ("medium", {})}, inputs)
    jax.start({"t3b": ("t3", dict(image_hw=IMAGE_HW, cases=cases[half:])),
               "c5": ("c5", dict(cases=list(CURVE_KINDS)))}, inputs)
    yield jax
    jax.close()


@pytest.mark.parametrize("name,footprint", T3_CASES,
                         ids=[f"{n}-{'mip' if f else 'level0'}" for n, f in T3_CASES])
def test_t3_twin_matches_jax_vjp(name, footprint, tex_tables, inputs, jax_side):
    case = f"{name}-{'mip' if footprint else 'level0'}"
    g = lambda k: torch.tensor(inputs[f"{case}:{k}"])
    width = g("width") if footprint else None
    got = tk.texture_coord_grad_plain(tex_tables, g("ids")[None], g("uv"), g("p"), width,
                                      g("g")[None])
    tag = "t3a" if T3_CASES.index((name, footprint)) < len(T3_CASES) // 2 else "t3b"
    res = jax_side.results(tag)
    for k, a in zip(("uv", "p", "width"), got):
        if a is None:
            continue
        want = res[f"{tag}:{case}:{k}"]
        if np.abs(want).max() > 0.0:
            close(a.numpy(), want, RTOL, T3_ATOL)
        else:
            assert float(a.abs().max()) == 0.0, k
    if name in ("fbm", "wrinkled", "marble", "windy", "imagemap", "uv"):
        assert float(got[0].abs().max() + got[1].abs().max()) > 0.0  # the leaf moves


def test_texture_fn_coordinates_match_autograd_of_plain(tex_tables):
    """TextureFn on the CPU in uv, p and width (T1's plain version forward,
    T3's twin backward), rows sharing the points and rows of their own,
    against autograd through the plain evaluation."""
    rng = np.random.default_rng(17)
    n, tb = 64, tex_tables
    ids = torch.tensor(rng.integers(0, tb.type.shape[0], (2, n)).astype(np.int32))
    g = torch.tensor(rng.normal(size=(2, n, 3)).astype(np.float32))
    for lead in ((n,), (2, n)):
        base = [torch.tensor(rng.uniform(0, 1, lead + (2,)).astype(np.float32)),
                torch.tensor(rng.uniform(-1, 1, lead + (3,)).astype(np.float32)),
                torch.tensor(rng.uniform(0, 0.1, n).astype(np.float32))]
        outs = []
        for fn in (tk.texture_eval, tk.plain):
            leaves = [x.clone().requires_grad_(True) for x in base]
            out = fn(tb, ids, *leaves)
            outs.append(torch.autograd.grad((out * g).sum(), leaves))
        for a, b in zip(*outs):
            close(a.numpy(), b.numpy())


@pytest.mark.parametrize("kind", CURVE_KINDS)
def test_c5_twin_matches_jax_vjp(kind, inputs, jax_side):
    g = lambda k: torch.tensor(inputs[f"{kind}:{k}"])
    rows = curve_rows(kind)
    n = g("o").shape[0]
    assert n > N_CURVE_RAYS // 2
    got = ck.curve_vjp_plain(g("o"), g("d"), g("seg").to(torch.int32), rows, *g("g").unbind(0))
    res = jax_side.results("c5")
    for a, k in zip(got, ("o", "d")):
        close(a.numpy(), res[f"c5:{kind}:{k}"], RTOL, C5_ATOL)
    # a lane without a hit gives zeros
    miss = ck.curve_vjp_plain(g("o")[:3], g("d")[:3], torch.full((3,), -1, dtype=torch.int32),
                              rows, *g("g")[:, :3].unbind(0))
    assert all(float(x.abs().max()) == 0.0 for x in miss)


def test_m3_and_m1_backward_match_jax_vjp(inputs, jax_side):
    """M3's twin and DeltaTrackFn's backward against the JAX tracking loops'
    vjps; the forwards against the JAX values."""
    scene = medium_scene()
    g = lambda k: torch.tensor(inputs["medium:" + k])
    tabs = vp._media_tables(scene)
    res = jax_side.results("medium")
    args = (g("mid"), g("in_med"))
    tr_ = mk.ratio_track(*tabs, *args, g("o"), g("d"), g("dist"), g("key"), 7, 3)
    np.testing.assert_allclose(tr_.numpy(), res["medium:tr"], rtol=1e-5, atol=1e-6)
    g_o, g_d = mk.ratio_track_vjp_plain(*tabs, *args, g("o"), g("d"), g("dist"), g("key"), 7, 3,
                                        g("g"))
    assert float(g_o.abs().max()) > 0.0
    close(g_o.numpy(), res["medium:ratio_o"])
    close(g_d.numpy(), res["medium:ratio_d"])
    # RatioTrackFn: the launch forward, the twin backward
    ot, dt = g("o").requires_grad_(True), g("d").requires_grad_(True)
    tr2 = mk.ratio_track(*tabs, *args, ot, dt, g("dist"), g("key"), 7, 3)
    assert torch.equal(tr2.detach(), tr_)
    a_o, a_d = torch.autograd.grad((tr2 * g("g")).sum(), [ot, dt])
    assert torch.equal(a_o, g_o) and torch.equal(a_d, g_d)
    # M1: DeltaTrackFn's select in t_max, nothing in o and d
    ot, dt, tt = (g(k).requires_grad_(True) for k in ("o", "d", "t_max"))
    _, t, _ = mk.delta_track(*tabs, *args, ot, dt, tt, g("key"), 1, 3)
    np.testing.assert_allclose(t.detach().numpy(), res["medium:delta_t"], rtol=1e-5, atol=1e-6)
    a_o, a_d, a_t = torch.autograd.grad((t * g("g")).sum(), [ot, dt, tt], allow_unused=True)
    assert a_o is None and a_d is None
    assert float(np.abs(res["medium:delta_o"]).max()) == 0.0
    assert float(np.abs(res["medium:delta_d"]).max()) == 0.0
    assert float(np.abs(res["medium:delta_tmax"][:8]).min()) > 0.0  # t_max -1 and 0
    close(a_t.numpy(), res["medium:delta_tmax"])


def _cfg(o, integrator="path"):
    return (rdr.RenderCfg(integrator, o["spp"], o["depth"], 1.0),
            smpl.make_sampler(smpl.SOBOL, o["spp"], (o["res"], o["res"])))


def test_realistic_camera_grad_matches_jax(jax_side):
    r = REALISTIC["res"]
    scene, _ = presets.cornell_box((r, r), device="cpu")
    camera = cam.make_realistic(tr.look_at((278, 273, -800), (278, 273, 0), (0, 1, 0)), (r, r),
                                SINGLET, aperture_diameter=8.0, focus_distance=1078.0,
                                film_diag_mm=35.0, device="cpu")
    loss, g = dg.grad_loss_wrt_camera(scene, camera, *_cfg(REALISTIC), MEAN)
    res = jax_side.results("realistic")
    np.testing.assert_allclose(float(loss), float(res["realistic:loss"]), rtol=1e-5)
    assert float(g.cam_to_world.abs().max()) > 0.0
    close(g.cam_to_world, res["realistic:g_cam_to_world"], RENDER_RTOL, RENDER_ATOL)
    close(g.raster_to_camera, res["realistic:g_raster_to_camera"], RENDER_RTOL, RENDER_ATOL)


def moving_quad():
    b = SceneBuilder()
    m = b.add_matte(kd=(0.8,) * 3)
    o = MOVING_SCENE
    b.add_animated_triangle_mesh([[0, 1, 2], [0, 2, 3]], o["quad"], tr.translate((0, 0, 0)),
                                 tr.translate(tuple(o["move"])), material=m)
    b.add_point_light(p=tuple(o["light"]), I=(5.0,) * 3)
    eye, at, up, fov = o["look"]
    return b.finalize("cpu"), cam.make_perspective(tr.look_at(eye, at, up), (MOVING["res"],) * 2,
                                                   fov=fov, device="cpu")


def test_moving_quad_camera_grad_matches_jax(jax_side):
    scene, camera = moving_quad()
    loss, g = dg.grad_loss_wrt_camera(scene, camera, *_cfg(MOVING), MEAN)
    res = jax_side.results("moving")
    np.testing.assert_allclose(float(loss), float(res["moving:loss"]), rtol=1e-5)
    assert float(g.cam_to_world[:3, 3].abs().max()) > 0.0
    close(g.cam_to_world, res["moving:g_cam_to_world"], RENDER_RTOL, RENDER_ATOL)
    close(g.raster_to_camera, res["moving:g_raster_to_camera"], RENDER_RTOL, RENDER_ATOL)


def _seen(scene, camera, cfg, scfg, accel, loss_fn):
    """(image, visibility, loss, CameraGrads) of a camera gradient render:
    the visibility is every closest hit's primitive, every shadow ray's
    occlusion and every delta-tracking collision of the render, one tensor
    a call."""
    sig, img = [], []

    def keep(mod, name, pick):
        fn = getattr(mod, name)

        def run(*a, **kw):
            res = fn(*a, **kw)
            sig.append(pick(res).detach().clone())
            return res
        return mod, name, run

    with ExitStack() as es:
        for mod, name, run in (keep(si, "scene_intersect", lambda r: r.prim),
                               keep(si, "scene_intersect_p", lambda r: r),
                               keep(mk, "delta_track", lambda r: r[0])):
            es.enter_context(_patched(mod, name, run))
        loss, g = dg.grad_loss_wrt_camera(
            scene, camera, cfg, scfg, lambda im: img.append(im.detach()) or loss_fn(im),
            accel=accel)
    return img[0].double(), sig, loss, g


class _patched:
    def __init__(self, mod, name, fn):
        self.mod, self.name, self.fn = mod, name, fn

    def __enter__(self):
        self.old = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.old)


def held_to_fd(scene, camera, cfg, scfg, accel=None, axes=(1, 2)):
    """The translation's gradient over the pixels whose samples keep their
    visibility under steps of FD_STEP along `axes`, against the central
    difference of the same masked loss; returns the full CameraGrads and
    the pixels held."""
    w, h = camera.resolution
    _, sig0, _, g_full = _seen(scene, camera, cfg, scfg, accel, MEAN)
    lanes = w * h * cfg.spp
    unstable = torch.zeros(w * h, dtype=torch.bool)
    imgs = {}
    for k in axes:
        for sgn in (1.0, -1.0):
            m = camera.cam_to_world.clone()
            m[k, 3] += sgn * FD_STEP
            imgs[k, sgn], sig, _, _ = _seen(scene, dataclasses.replace(camera, cam_to_world=m),
                                            cfg, scfg, accel, MEAN)
            assert len(sig) == len(sig0)
            for a, b in zip(sig0, sig):
                assert a.shape == b.shape == (lanes,)
                unstable[torch.nonzero(a != b).flatten() % (w * h)] = True  # x fastest
    keep_px = (~unstable).reshape(h, w)
    assert int(keep_px.sum()) >= (w * h) // 2, int(keep_px.sum())
    weights = keep_px.to(torch.float32)[..., None] / (w * h * 3)
    _, gm = dg.grad_loss_wrt_camera(scene, camera, cfg, scfg, lambda im: (im * weights).sum(),
                                    accel=accel)
    for x in gm:
        assert bool(torch.isfinite(x).all())
    for k in axes:
        fd = float(((imgs[k, 1.0] - imgs[k, -1.0]) * weights.double()).sum()) / (2 * FD_STEP)
        ad = float(gm.cam_to_world[k, 3])
        assert abs(ad - fd) <= CAM_FD_RTOL * abs(fd), (k, ad, fd)
    return g_full, int(keep_px.sum())


def textured_quad():
    """A quad image-mapped by a seeded 16x16 image (its MIP pyramid) under
    a point light."""
    b = SceneBuilder()
    tid = b.add_texture(tx.TEX_IMAGEMAP, {tx.TP_GAMMA_SCALE: 1.0},
                        image=ts.seeded_image((16, 16), 23))
    m = b.add_matte()
    b.set_material_texture(m, 0, tid)
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]], [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                        uvs=[[0, 0], [1, 0], [1, 1], [0, 1]], material=m)
    b.add_point_light(p=(0.5, 0.5, 2.0), I=(5.0,) * 3)
    return b.finalize("cpu")


def test_image_mapped_quad_camera_grad_matches_fd():
    """The image-mapped quad seen whole (T1 forward, T3 backward in uv, p
    and the footprint's width)."""
    camera = cam.make_perspective(tr.look_at([0.2, 0.1, 4], [0, 0, 0], [0, 1, 0]), (8, 8),
                                  fov=20.0, device="cpu")
    calls = []
    with _patched(tk, "texture_coord_grad",
                  lambda *a: calls.append(a[4] is not None) or tk.texture_coord_grad_plain(*a)):
        g, _ = held_to_fd(textured_quad(), camera, *_cfg(dict(res=8, spp=2, depth=1)))
    assert True in calls  # the camera rays' footprints took T3
    assert float(g.cam_to_world[:3, 3].abs().max()) > 0.0


HAIR_VIEW = ([0.0, 0.7, 1.6], [0.05, 0.5, 0.0], [0, 1, 0], 30.0)


def hair_patch():
    from rs_pbrt_tpu_torch.tools import hair_scenes

    scene, _ = hair_scenes.hair_patch((8, 8), device="cpu")
    eye, at, up, fov = HAIR_VIEW
    return scene, cam.make_perspective(tr.look_at(eye, at, up), (8, 8), fov=fov, device="cpu")


def test_hair_patch_camera_grad_c3_and_c1_match_fd(monkeypatch):
    """The hair patch through the curve sweep C3 and through the curve
    tree C1 (its 48 segments above a lowered sweep limit), C5 the backward
    of both: each held to the central difference, and C1's gradient equal
    to C3's."""
    scene, camera = hair_patch()
    cfg, scfg = _cfg(dict(res=8, spp=2, depth=1))
    calls = []
    monkeypatch.setattr(ck, "curve_vjp",
                        lambda *a: calls.append(int((a[2] >= 0).sum())) or ck.curve_vjp_plain(*a))
    g3, _ = held_to_fd(scene, camera, cfg, scfg)
    assert calls and max(calls) > 0  # hair lanes took C5
    monkeypatch.setattr(si, "BRUTE_FORCE_MAX_CURVES", 16)
    accel = si.build_accel(scene, device="cpu")
    assert si.uses_curve_bvh(scene, accel)
    g1, _ = held_to_fd(scene, camera, cfg, scfg, accel)
    close(g1.cam_to_world, g3.cam_to_world, 1e-5, 1e-6)


def test_grid_medium_volpath_camera_grad_matches_fd():
    """The camera in a grid medium (tests/_volpath.grid, scattering 0.5)
    facing an emitting wall, volpath at depth 1: M1 (its select) on the
    camera rays, M2 (M3 its backward) on the shadow rays of the scattering
    lanes."""
    scene = medium_scene()
    camera = cam.make_perspective(tr.look_at([0.3, 0.2, -4], [0, 0, 5], [0, 1, 0]), (8, 8),
                                  fov=40.0, device="cpu")
    calls = []
    with _patched(mk, "ratio_track_vjp", lambda *a: calls.append(1) or
                  mk.ratio_track_vjp_plain(*a)):
        g, _ = held_to_fd(scene, camera, *_cfg(dict(res=8, spp=2, depth=1), "volpath"))
    assert calls and float(g.cam_to_world[:3, 3].abs().max()) > 0.0


def test_camera_grad_finite_through_quadrics_sky_and_subsurface():
    """Lanes a select drops pass no NaN: the quadrics' discriminant, the
    sky's polar angle, Fresnel's square roots (glass, the subsurface
    exit) give finite, non-zero camera gradients on quadric_env (path,
    depth 2) and sss_dragonette (volpath, depth 1)."""
    from rs_pbrt_tpu_torch.tools import env_scenes, sss_scenes

    res = 16
    for (scene, camera), integrator, depth in (
            (env_scenes.quadric_env((res, res), sky_hw=(16, 32), device="cpu"), "path", 2),
            (sss_scenes.sss_dragonette((res, res), device="cpu"), "volpath", 1)):
        cfg = rdr.RenderCfg(integrator, 2, depth, 1.0)
        _, g = dg.grad_loss_wrt_camera(scene, camera, cfg,
                                       smpl.make_sampler(smpl.SOBOL, 2, (res, res)), MEAN)
        assert all(bool(torch.isfinite(x).all()) for x in g), integrator
        assert float(g.cam_to_world.abs().max()) > 0.0
