"""The port's .pbrt front end (rs_pbrt_tpu_torch/scene/parser.py,
scene/api.py, main.py) against the JAX package's on the same files.

The files are the five scenes of assets/scenes/ and the snippets of
tests/_pbrtfiles.py, written to a temporary directory with the meshes,
images, lens, spectrum and SCATFUN files they read.  For each file:
- the parser's statement lists are equal;
- load_pbrt gives the JAX load_pbrt's results: every field of the port's
  Scene equal to that of the JAX scene's tables carried across
  (scene_from_numpy of BRIDGE_FIELDS), the camera's fields equal to
  camera_from_numpy's of the JAX camera, the RenderCfg, SamplerCfg and
  FilterCfg equal field for field, the output name, and the same warnings
  printed.  Every table is built on the host by both packages, so
  equality is exact (torch.equal, NaN matching NaN).  The one value JAX
  computes on jnp, an "xyz" parameter's RGB (find_spectrum), is numpy in
  the port; the lights snippet's "xyz I" [5 6 4] comes out bit-equal, so
  no field needs a tolerance (tests/test_torch_io.py holds xyz_to_rgb
  within 1e-6 on other inputs).  A file that makes the JAX load raise makes the port's raise
  the same exception type.
The JAX side is loaded once per module; no JAX render runs here.  main on
the CPU writes the PNG of the port's render of the JAX scene's tables at
the same crop.
"""

import contextlib
import dataclasses
import functools
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rs_pbrt_tpu.scene import parser as jps
from rs_pbrt_tpu.scene.api import load_pbrt as jax_load_pbrt
from rs_pbrt_tpu_torch import main as port_main
from rs_pbrt_tpu_torch.io.image import write_png
from rs_pbrt_tpu_torch.models import cameras as cam
from rs_pbrt_tpu_torch.models import lightdistrib as ldist
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.ops import film as filmmod
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene import parser as ps
from rs_pbrt_tpu_torch.scene.api import load_pbrt

from _pbrtfiles import snippets, write_assets

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ASSETS = {p.stem: p for p in sorted((ROOT / "assets" / "scenes").glob("*.pbrt"))}
# the snippet names, fixed here so that pytest can collect them
SNIPPETS = (
    "shapes", "materials", "textures", "textured_sigma", "textured_roughness", "lights", "infinite_constant", "media", "instances",
    "motion", "camera_perspective_lens", "camera_orthographic", "camera_environment",
    "camera_realistic", "sampler_sobol", "sampler_random", "sampler_lowdiscrepancy",
    "sampler_02sequence", "sampler_stratified", "sampler_halton", "sampler_maxmindist",
    "sampler_unknownsampler", "filter_box", "filter_triangle", "filter_gaussian",
    "filter_mitchell", "filter_sinc", "filter_unknownfilter", "integrator_path_uniform",
    "integrator_path_power", "integrator_path_unknown_strategy", "integrator_volpath",
    "integrator_whitted", "integrator_directlighting", "integrator_ao", "integrator_sppm",
    "integrator_sppm_iterations", "integrator_bdpt", "integrator_mlt", "crop_accel_film",
    "overrides", "include")
CASES = tuple(ASSETS) + SNIPPETS


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """case -> (path, overrides)."""
    d = tmp_path_factory.mktemp("pbrt")
    write_assets(d)
    cases = snippets(d)
    assert sorted(cases) == sorted(SNIPPETS)
    out = {name: (path, None) for name, path in ASSETS.items()}
    for name, (text, overrides) in cases.items():
        (d / f"{name}.pbrt").write_text(text)
        out[name] = (d / f"{name}.pbrt", overrides)
    return out


def _loaded(load, path, overrides, **kw):
    """(result or the exception raised, what the load printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            got = load(str(path), overrides, **kw)
        except Exception as e:  # compared by type with the other package's
            got = e
    return got, buf.getvalue()


@pytest.fixture(scope="module")
def jax_loads(files):
    """case -> (the JAX load_pbrt's results as numpy tables and fields, or
    the exception it raised; what it printed)."""
    out = {}
    for name, (path, overrides) in files.items():
        got, printed = _loaded(jax_load_pbrt, path, overrides)
        if not isinstance(got, Exception):
            scene, camera, cfg, scfg, fcfg, out_name = got
            got = ({k: np.asarray(getattr(scene, k)) for k in sa.BRIDGE_FIELDS},
                   {f.name: getattr(camera, f.name) for f in dataclasses.fields(camera)},
                   cfg, scfg, fcfg, out_name)
        out[name] = (got, printed)
    return out


def assert_same(got, want, where):
    """got and want equal, recursively through dataclasses, named tuples,
    sequences and dicts: tensors by torch.equal (NaN matching NaN) with
    the same dtype and shape, floats NaN matching NaN."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif torch.is_tensor(want):
        assert torch.is_tensor(got), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        same = torch.equal(got, want) or (torch.equal(got.isnan(), want.isnan())
                                          and torch.equal(got.nan_to_num(), want.nan_to_num()))
        assert same, where
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name), f"{where}.{f.name}")
    elif isinstance(want, tuple) and hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__, where
        for k in want._fields:
            assert_same(getattr(got, k), getattr(want, k), f"{where}.{k}")
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, float) and want != want:
        assert got != got, where
    else:
        assert got == want and type(got) is type(want), f"{where}: {got!r} != {want!r}"


@pytest.mark.parametrize("case", CASES)
def test_parser_statements_match(case, files):
    path = files[case][0]
    got = [(s.name, s.args, s.params) for s in ps.parse_file(path)]
    want = [(s.name, s.args, s.params) for s in jps.parse_file(path)]
    assert got == want
    assert len(got) > 3


@pytest.mark.parametrize("text", [
    "Bogus 1 2 3",  # unknown statement
    'Shape "sphere" @',  # no token starts with @
    "1 2 3",  # a statement must start with a name
    '"sphere"',
    'Include "no_such_file.pbrt"',
    # both parsers take a matrix's numbers but leave its closing bracket
    "Transform [1 0 0 0  0 1 0 0  0 0 1 0  0 0 0 1]",
])
def test_parser_errors_match(text, tmp_path):
    with pytest.raises(Exception) as want:
        list(jps.parse_statements(text, tmp_path))
    with pytest.raises(want.type):
        list(ps.parse_statements(text, tmp_path))


@pytest.mark.parametrize("case", CASES)
def test_load_pbrt_matches_jax(case, files, jax_loads):
    path, overrides = files[case]
    want, want_printed = jax_loads[case]
    got, printed = _loaded(load_pbrt, path, overrides, device="cpu")
    # the same warnings; a failed image load's reason is each package's own
    reason = lambda text: re.sub(r"load failed \(.*\)", "load failed", text)
    assert reason(printed) == reason(want_printed)
    if isinstance(want, Exception):
        assert type(got) is type(want), (got, want)
        return
    assert not isinstance(got, Exception), got
    tables, cam_fields, cfg, scfg, fcfg, out_name = want
    scene, camera = got[0], got[1]
    assert scene.device.type == camera.device.type == "cpu"
    assert_same(scene, sa.scene_from_numpy(tables, device="cpu"), "scene")
    assert_same(camera, cam.camera_from_numpy(cam_fields, device="cpu"), "camera")
    assert_same(tuple(got[2]), tuple(cfg), "RenderCfg")
    assert_same(tuple(got[3]), tuple(scfg), "SamplerCfg")
    assert_same(tuple(got[4]), tuple(fcfg), "FilterCfg")
    assert got[5] == out_name


def test_snippets_reach_the_api(jax_loads):
    """The snippets build what they are written to build (so the
    comparison above is not of empty scenes)."""
    shapes = jax_loads["shapes"][0][0]
    assert len(shapes["sph_o2w"]) == 4 and len(shapes["crv_attr"]) > 0
    assert jax_loads["instances"][0][0]["inst_o2w"].shape[0] == 40
    assert len(jax_loads["motion"][0][0]["anim_range"]) == 4
    assert jax_loads["motion"][0][1]["anim"]
    assert jax_loads["textures"][0][0]["tex_atlas"].shape[0] > 1
    assert len(jax_loads["materials"][0][0]["bss_eta"]) == 3
    assert len(jax_loads["materials"][0][0]["fou_mu"]) == 12
    assert jax_loads["media"][0][0]["med_grid"].shape == (5, 2, 2, 3)
    assert "WARNING" in jax_loads["textures"][1] and "WARNING" in jax_loads["shapes"][1]
    assert isinstance(jax_loads["textured_sigma"][0], ValueError)
    assert isinstance(jax_loads["textured_roughness"][0], ValueError)


def test_main_cpu_writes_the_bridged_render(tmp_path, capsys, monkeypatch):
    """main --device cpu --samples 1 on the Cornell file with a centred
    crop of 50x50 pixels writes the PNG of the port's render of the JAX
    load_pbrt's tables, carried across, at the same crop.  The file's
    spatial light selection is built at 16 voxels along the longest axis
    for both renders (64, the default, takes ~13 s a render on the CPU)."""
    monkeypatch.setattr(ldist, "build_spatial",
                        functools.partial(ldist.build_spatial, max_voxels=16))
    crop = (0.45, 0.55, 0.45, 0.55)
    path = ASSETS["cornell_box"]
    out = tmp_path / "main.png"
    argv = ["--path", str(path), "--device", "cpu", "--samples", "1", "--out", str(out)]
    for flag, v in zip(("--cropx0", "--cropx1", "--cropy0", "--cropy1"), crop):
        argv += [flag, str(v)]
    assert port_main.main(argv) == 0
    printed = capsys.readouterr().out
    assert "32 triangles, 0 spheres, 1 lights" in printed and 'Integrator "path"' in printed

    jscene, jcamera, jcfg, jscfg, jfcfg, _ = jax_load_pbrt(str(path), {"samples": 1})
    scene = sa.scene_from_numpy({k: np.asarray(getattr(jscene, k)) for k in sa.BRIDGE_FIELDS},
                                device="cpu")
    camera = cam.camera_from_numpy({f.name: getattr(jcamera, f.name)
                                    for f in dataclasses.fields(jcamera)}, device="cpu")
    cfg = rdr.RenderCfg(*jcfg)
    assert cfg.light_strategy == "spatial" and jscfg.spp == 1
    assert si.build_accel(scene, device="cpu") == si.Accel()  # main renders without a tree
    img = rdr.render(scene, camera, cfg, smpl.SamplerCfg(*jscfg), filmmod.FilterCfg(*jfcfg),
                     crop=crop)
    rect = rdr.crop_pixel_rect(camera.resolution, crop)
    assert (rect[1] - rect[0], rect[3] - rect[2]) == (50, 50)
    assert img[rect[2]:rect[3], rect[0]:rect[1]].sum() > 0
    write_png(tmp_path / "want.png", img)
    assert out.read_bytes() == (tmp_path / "want.png").read_bytes()


@pytest.mark.parametrize("argv,what", [
    (["--path", "scene.ass", "--device", "cpu"], ".ass"),
    (["--path", "scene.blend", "--device", "cpu"], ".ass and .blend"),
    (["--path", str(ROOT / "assets/scenes/cornell_box.pbrt"), "--ndevices", "2",
      "--device", "cpu"], "--ndevices"),
])
def test_main_raises_for_a18b(argv, what):
    """The .ass and .blend importers and the multi-device path come with
    ROADMAP A18b."""
    with pytest.raises(NotImplementedError, match="A18b"):
        port_main.main(argv)
