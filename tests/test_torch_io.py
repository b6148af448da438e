"""The port's readers and host utilities against the JAX package's on the
same seeded inputs: io/plyloader, io/subdiv, io/nurbs, io/floatfile,
io/measured_ss (and the builder's measured subsurface presets),
io/image's readers, utils/spectrum and utils/transform's rotations.

Every function here is host numpy in both packages and gives bit-equal
results, except the JAX spectrum functions that run on jnp (luminance,
rgb_to_xyz, xyz_to_rgb, gamma_correct, inverse_gamma_correct): XLA's
sums and powers round otherwise (up to ~7e-7 apart on values near 2), so
those are held to rtol 1e-6, atol 1e-6.  The PNG decoder is held to PIL's convert("RGB") through the
JAX read_image, bit for bit, for every colour type and bit depth but
16-bit grey, where PIL clips each sample at 255 instead of keeping its
high byte as it does for every other 16-bit type; the port keeps the
high byte there too.
"""

import numpy as np
import pytest
import torch

from rs_pbrt_tpu.io import floatfile as jff
from rs_pbrt_tpu.io import image as jimg
from rs_pbrt_tpu.io import measured_ss as jms
from rs_pbrt_tpu.io import nurbs as jnurbs
from rs_pbrt_tpu.io import plyloader as jply
from rs_pbrt_tpu.io import subdiv as jsub
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu.utils import spectrum as jsp
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu_torch.io import floatfile, image, measured_ss, nurbs, plyloader, subdiv
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.utils import spectrum as sp
from rs_pbrt_tpu_torch.utils import transform as tr

from _pbrtfiles import PNG_CHANNELS, png_bytes, write_hdr, write_pfm, write_ply

torch.set_num_threads(2)


def assert_equal_or_none(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt,normals,uv", [
    ("ascii", True, ("u", "v")), ("ascii", False, ("s", "t")),
    ("binary_little_endian", True, ("texture_u", "texture_v")),
    ("binary_big_endian", False, ("u", "v")), ("binary_big_endian", True, ("s", "t"))])
def test_load_ply(fmt, normals, uv, tmp_path):
    path = write_ply(tmp_path / "m.ply", np.random.default_rng(3), fmt, normals, uv)
    got, want = plyloader.load_ply(path), jply.load_ply(path)
    for g, w in zip(got, want):
        assert_equal_or_none(g, w)
    assert got[1].shape == (5, 3)  # three triangles and a quad's two
    assert (got[2] is not None) == normals


def test_load_ply_rejects_other_files(tmp_path):
    (tmp_path / "x.ply").write_bytes(b"not a ply")
    with pytest.raises(IOError):
        plyloader.load_ply(tmp_path / "x.ply")


def _tetra(rng):
    return rng.normal(size=(4, 3)), np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]])


@pytest.mark.parametrize("levels", [0, 1, 3])
@pytest.mark.parametrize("mesh", ["closed", "open"])
def test_loop_subdivide(mesh, levels):
    rng = np.random.default_rng(11)
    if mesh == "closed":
        P, F = _tetra(rng)
    else:  # a patch with a boundary
        P = rng.normal(size=(6, 3))
        F = np.array([[0, 1, 2], [1, 3, 2], [2, 3, 4], [3, 5, 4]])
    got, want = subdiv.loop_subdivide(P, F, levels), jsub.loop_subdivide(P, F, levels)
    for g, w in zip(got, want):
        assert_equal_or_none(g, w)
    assert got[1].shape == (len(F) * 4 ** levels, 3)


@pytest.mark.parametrize("weights", [False, True])
def test_tessellate_nurbs(weights):
    rng = np.random.default_rng(5)
    nu, nv, uo, vo = 5, 4, 3, 2
    uk = [0, 0, 0, 0.3, 0.6, 1, 1, 1]
    vk = [0, 0, 0.4, 0.7, 1, 1]
    P = rng.normal(size=(nu * nv, 3)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, nu * nv).astype(np.float32) if weights else None
    got = nurbs.tessellate_nurbs(uo, uk, nu, vo, vk, nv, P, w, diceu=9, dicev=7)
    want = jnurbs.tessellate_nurbs(uo, uk, nu, vo, vk, nv, P, w, diceu=9, dicev=7)
    for g, x in zip(got, want):
        assert_equal_or_none(g, x)
    assert got[0].shape == (63, 3) and got[1].shape == (2 * 8 * 6, 3)


def test_read_float_file(tmp_path):
    rng = np.random.default_rng(2)
    vals = rng.normal(size=20).tolist()
    lines = ["# a header", " ".join(map(repr, vals[:7])) + "  # trailing comment", "",
             "\t".join(map(repr, vals[7:]))]
    (tmp_path / "f.dat").write_text("\n".join(lines))
    got = floatfile.read_float_file(tmp_path / "f.dat")
    assert got == jff.read_float_file(tmp_path / "f.dat") == vals


def test_measured_ss_table():
    assert measured_ss.SUBSURFACE_PARAMETER_TABLE == jms.SUBSURFACE_PARAMETER_TABLE
    for name in list(jms.SUBSURFACE_PARAMETER_TABLE) + ["no such medium"]:
        assert (measured_ss.get_medium_scattering_properties(name)
                == jms.get_medium_scattering_properties(name))


@pytest.mark.parametrize("name", ["Skin1", "Ketchup", "Regular Milk", "unknown"])
def test_builder_measured_subsurface(name):
    """add_subsurface(name=) takes the measured preset's coefficients, as
    the JAX builder does: the same material and BSSRDF tables."""
    def build(builder_cls):
        b = builder_cls()
        b.add_subsurface(name=name, scale=2.0, eta=1.4, g=0.2)
        b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=1)
        return b

    got = build(SceneBuilder).finalize("cpu")
    jscene = build(JaxBuilder).finalize()
    for k in ("mat_attr", "bss_profile", "bss_cdf", "bss_rho_eff", "bss_sigma_t", "bss_eta"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(jscene, k)),
                                      err_msg=k)
    assert got.has_subsurface


# (colour type, bit depth): every combination PNG allows
PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8),
             (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_matches_pil(ctype, depth, tmp_path):
    """The port's read_image of a PNG (rows of all five filters, the image
    data split over two chunks) equals the JAX read_image's, which decodes
    with PIL."""
    rng = np.random.default_rng(ctype * 100 + depth)
    samples = rng.integers(0, 2 ** depth, (9, 13, PNG_CHANNELS[ctype]))
    palette = rng.integers(0, 256, (2 ** depth, 3)) if ctype == 3 else None
    path = tmp_path / "im.png"
    path.write_bytes(png_bytes(samples, depth, ctype, palette))
    got, want = image.read_image(path), jimg.read_image(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, want)


def test_png_gray16_keeps_the_high_byte(tmp_path):
    """16-bit grey: the port keeps each sample's high byte, as PIL does for
    every other 16-bit type; PIL's convert("RGB") of its "I;16" mode clips
    at 255 instead (so the JAX read_image differs here)."""
    rng = np.random.default_rng(16)
    samples = rng.integers(0, 1 << 16, (5, 6, 1))
    path = tmp_path / "g16.png"
    path.write_bytes(png_bytes(samples, 16, 0))
    hi = np.repeat((samples >> 8).astype(np.uint8), 3, -1)
    np.testing.assert_array_equal(image.decode_png(path.read_bytes()), hi)
    ref = tmp_path / "g8.png"  # the same high bytes as an 8-bit grey file
    ref.write_bytes(png_bytes(samples >> 8, 8, 0))
    np.testing.assert_array_equal(image.read_image(path), jimg.read_image(ref))


def test_png_round_trip(tmp_path):
    """write_png's file decodes to its own sRGB bytes."""
    img = np.random.default_rng(9).uniform(0, 1.5, (7, 11, 3)).astype(np.float32)
    image.write_png(tmp_path / "o.png", img)
    np.testing.assert_array_equal(image.decode_png((tmp_path / "o.png").read_bytes()),
                                  image.to_srgb_u8(img))


@pytest.mark.parametrize("kind", ["hdr_flat", "hdr_rle", "pfm_rgb_le", "pfm_grey_be", "npy"])
def test_float_images_match(kind, tmp_path):
    rng = np.random.default_rng(len(kind))
    if kind.startswith("hdr"):
        path = write_hdr(tmp_path / "im.hdr", rng, 6, 20, rle=kind == "hdr_rle")
    elif kind.startswith("pfm"):
        path = write_pfm(tmp_path / "im.pfm", rng, 5, 7, colour="rgb" in kind,
                         little=kind.endswith("le"))
    else:
        path = tmp_path / "im.npy"
        np.save(path, rng.uniform(0, 2, (3, 4, 3)))
    got, want = image.read_image(path), jimg.read_image(path)
    assert got.dtype == want.dtype == np.float32 and got.ndim == 3 and got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,data", [
    ("sky.exr", b"\x76\x2f\x31\x01"), ("im.tga", bytes(18)), ("im.jpg", b"\xff\xd8\xff\xe0")])
def test_other_formats_raise(name, data, tmp_path):
    (tmp_path / name).write_bytes(data)
    with pytest.raises(NotImplementedError, match="A18b"):
        image.read_image(tmp_path / name)


def test_interlaced_png_raises():
    data = bytearray(png_bytes(np.zeros((2, 2, 3), int), 8, 2))
    data[28] = 1  # IHDR's interlace byte (the CRC is not checked)
    with pytest.raises(NotImplementedError, match="A18b"):
        image.decode_png(bytes(data))


@pytest.fixture(scope="module")
def rgb():
    rng = np.random.default_rng(21)
    x = rng.uniform(-0.1, 2.0, (64, 3)).astype(np.float32)
    x[:4] = 0.0
    x[4:8] = np.array([0.0031308, 0.04045, 1.0, 0.5])[:, None]  # the curves' knees
    return x


@pytest.mark.parametrize("fn", ["luminance", "rgb_to_xyz", "xyz_to_rgb", "gamma_correct",
                                "inverse_gamma_correct"])
def test_spectrum_jnp_functions(fn, rgb):
    x = np.abs(rgb) if fn == "inverse_gamma_correct" else rgb
    got = getattr(sp, fn)(x)
    want = np.asarray(getattr(jsp, fn)(x))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_spectrum_host_functions(rgb):
    np.testing.assert_array_equal(sp.is_black(rgb), np.asarray(jsp.is_black(rgb)))
    lams = np.linspace(360, 830, 95)
    for temp in (0.0, 1800.0, 3000.0, 6500.0, 12000.0):
        np.testing.assert_array_equal(sp.blackbody(lams, temp), jsp.blackbody(lams, temp))
    for temp in (1800.0, 6500.0):
        np.testing.assert_array_equal(sp.blackbody_normalized(lams, temp),
                                      jsp.blackbody_normalized(lams, temp))
        spd = sp.blackbody_normalized(lams, temp)
        np.testing.assert_array_equal(sp.spd_to_rgb(lams, spd), jsp.spd_to_rgb(lams, spd))
    assert sp.copper_rgb() == jsp.copper_rgb()


@pytest.mark.parametrize("deg", [0.0, 30.0, -127.5, 90.0])
def test_rotations(deg):
    axis = np.random.default_rng(int(deg) & 255).normal(size=3)
    for got, want in ((tr.rotate_x(deg), jtr.rotate_x(deg)), (tr.rotate_y(deg), jtr.rotate_y(deg)),
                      (tr.rotate_z(deg), jtr.rotate_z(deg)), (tr.rotate(deg, axis),
                                                              jtr.rotate(deg, axis))):
        np.testing.assert_array_equal(got.m, np.asarray(want.m))
        np.testing.assert_array_equal(got.m_inv, np.asarray(want.m_inv))
        assert got.m.dtype == np.float32
