"""Files for the port's front-end tests (tests/test_torch_frontend.py,
tests/test_torch_io.py), written by the tests themselves: PNG images of
every colour type and bit depth with every row filter, Radiance .hdr
(flat and run-length encoded), .pfm, ASCII and binary PLY meshes, a
SCATFUN table, a lens file, an .spd spectrum, and the .pbrt snippet scenes
that reach every shape, material, texture, light, camera, sampler, filter
and integrator parameter of the scene API.  Everything is made from seeds
with numpy.
"""

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_bytes(samples, depth, ctype, palette=None, filters=(0, 1, 2, 3, 4)):
    """A non-interlaced PNG of samples (H, W, channels) ints at bit depth
    `depth` and colour type `ctype`, row y filtered with
    filters[y % len(filters)], the IDAT split in two chunks."""
    h, w = samples.shape[:2]
    a = np.asarray(samples).reshape(h, w, PNG_CHANNELS[ctype])
    if depth == 16:
        rows = a.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = a.astype(np.uint8).reshape(h, -1)
    else:
        bits = np.unpackbits(a.astype(np.uint8), axis=-1)[..., 8 - depth:].reshape(h, -1)
        rows = np.packbits(bits, axis=1)
    bpp = max(1, PNG_CHANNELS[ctype] * depth // 8)
    out, prior = b"", np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        f, r = filters[y % len(filters)], rows[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = {0: 0 * r, 1: left, 2: prior, 3: (left + prior) // 2,
                4: _paeth(left, prior, up_left)}[f]
        out += bytes([f]) + ((r - pred) % 256).astype(np.uint8).tobytes()
        prior = r

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    z = zlib.compress(out)
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                               0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (data + chunk(b"IDAT", z[:len(z) // 2]) + chunk(b"IDAT", z[len(z) // 2:])
            + chunk(b"IEND", b""))


def write_png(path, rng, h, w, depth=8, ctype=2):
    """A random PNG of h x w pixels at path; returns path."""
    samples = rng.integers(0, 2 ** depth, (h, w, PNG_CHANNELS[ctype]))
    palette = rng.integers(0, 256, (2 ** min(depth, 8), 3)) if ctype == 3 else None
    Path(path).write_bytes(png_bytes(samples, depth, ctype, palette))
    return path


def write_hdr(path, rng, h, w, rle):
    """A random Radiance RGBE file, its scanlines run-length encoded (runs
    and literals) or flat."""
    rgbe = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (h, w))
    rgbe[0, 0, 3] = 0  # a black pixel
    body = b""
    for y in range(h):
        if not rle:
            body += rgbe[y].tobytes()
            continue
        body += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row = rgbe[y, :, c].copy()
            row[: w // 2] = row[0]  # a run, then literals
            half = w // 2
            body += bytes([128 + half, row[0]]) + bytes([w - half]) + row[half:].tobytes()
    Path(path).write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                           + f"-Y {h} +X {w}\n".encode() + body)
    return path


def write_pfm(path, rng, h, w, colour=True, little=True):
    n = 3 if colour else 1
    data = rng.uniform(0.0, 4.0, (h, w, n)).astype("<f4" if little else ">f4")
    Path(path).write_bytes((b"PF\n" if colour else b"Pf\n") + f"{w} {h}\n".encode()
                           + (b"-1.0\n" if little else b"1.0\n") + data.tobytes())
    return path


def ply_mesh(rng, n_vert=9):
    """A random mesh of triangles and a quad: vertices (V, 3), normals,
    uvs and faces (a list of index lists)."""
    V = rng.uniform(-1, 1, (n_vert, 3)).astype(np.float32)
    N = rng.normal(size=(n_vert, 3)).astype(np.float32)
    N /= np.linalg.norm(N, axis=1, keepdims=True)
    UV = rng.uniform(0, 1, (n_vert, 2)).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4, 5], [5, 6, 7], [7, 8, 0]]
    return V, N, UV, faces


def write_ply(path, rng, fmt="ascii", normals=True, uv_names=("u", "v")):
    """A PLY file of ply_mesh in format fmt ("ascii", "binary_little_endian"
    or "binary_big_endian"), with an extra vertex property and a trailing
    element the loader skips."""
    V, N, UV, faces = ply_mesh(rng)
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals else []) + list(uv_names)
    cols = [V[:, 0], V[:, 1], V[:, 2]] + ([N[:, 0], N[:, 1], N[:, 2]] if normals else []) \
        + [UV[:, 0], UV[:, 1]]
    head = ["ply", f"format {fmt} 1.0", "comment made by the test", f"element vertex {len(V)}"]
    head += [f"property float {p}" for p in props] + ["property uchar flags"]
    head += [f"element face {len(faces)}", "property list uchar int vertex_indices",
             "element extra 2", "property short k"]
    head = ("\n".join(head + ["end_header"]) + "\n").encode()
    if fmt == "ascii":
        body = "".join(" ".join(f"{float(c[i])!r}" for c in cols) + " 1\n" for i in range(len(V)))
        body += "".join(f"{len(f)} " + " ".join(map(str, f)) + "\n" for f in faces)
        body += "3\n4\n"
        Path(path).write_bytes(head + body.encode())
        return path
    e = "<" if fmt == "binary_little_endian" else ">"
    vdt = np.dtype([(p, e + "f4") for p in props] + [("flags", "u1")])
    vert = np.zeros(len(V), vdt)
    for p, c in zip(props, cols):
        vert[p] = c
    body = vert.tobytes()
    for f in faces:
        body += struct.pack(e + "B" + "i" * len(f), len(f), *f)
    body += struct.pack(e + "hh", 3, 4)
    Path(path).write_bytes(head + body)
    return path


def write_scatfun(path, tab):
    """tab (tools/material_scenes.glossy_fourier_table's dict) as a SCATFUN
    v1 file (reflection.rs:80-187)."""
    n_mu = tab["mu"].shape[0]
    with open(path, "wb") as f:
        f.write(b"SCATFUN\x01")
        f.write(struct.pack("<9i", 1, n_mu, tab["a"].shape[0], tab["m_max"], 3, 1, 0, 0, 0))
        f.write(struct.pack("<f", tab["eta"]))
        f.write(struct.pack("<4i", 0, 0, 0, 0))
        f.write(tab["mu"].astype("<f4").tobytes())
        f.write(tab["cdf"].astype("<f4").tobytes())
        f.write(np.stack([tab["a_offset"], tab["m"]], 1).astype("<i4").tobytes())
        f.write(tab["a"].astype("<f4").tobytes())


LENS = """# a singlet and a stop (radius thickness eta aperture), scene side first
50.0 5.0 1.5 20.0
-50.0 2.0 1.0 20.0
0.0 45.0 0.0 12.0
"""

HEAD = """LookAt 0 2 -6  0 0.5 0  0 1 0
Camera "perspective" "float fov" 50
Film "image" "integer xresolution" 16 "integer yresolution" 12
"""
QUAD = '''Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]'''
ICOSA_P = (" ".join(f"{v:.6f}" for v in np.array(
    [[-1, 1.618034, 0], [1, 1.618034, 0], [-1, -1.618034, 0], [1, -1.618034, 0],
     [0, -1, 1.618034], [0, 1, 1.618034], [0, -1, -1.618034], [0, 1, -1.618034],
     [1.618034, 0, -1], [1.618034, 0, 1], [-1.618034, 0, -1], [-1.618034, 0, 1]]).ravel()))
ICOSA_F = ("0 11 5 0 5 1 0 1 7 0 7 10 0 10 11 1 5 9 5 11 4 11 10 2 10 7 6 7 1 8 "
           "3 9 4 3 4 2 3 2 6 3 6 8 3 8 9 4 9 5 2 4 11 6 2 10 8 6 7 9 8 1")


def write_assets(d: Path):
    """Writes the files the snippets read into directory d."""
    rng = np.random.default_rng(7)
    write_ply(d / "mesh_ascii.ply", rng, "ascii")
    write_ply(d / "mesh_le.ply", rng, "binary_little_endian", uv_names=("s", "t"))
    write_ply(d / "mesh_be.ply", rng, "binary_big_endian", normals=False,
              uv_names=("texture_u", "texture_v"))
    write_png(d / "rgb8.png", rng, 6, 10, 8, 2)
    write_png(d / "rgba16.png", rng, 5, 7, 16, 6)
    write_png(d / "palette4.png", rng, 6, 5, 4, 3)
    write_hdr(d / "flat.hdr", rng, 4, 8, rle=False)
    write_hdr(d / "rle.hdr", rng, 8, 16, rle=True)
    write_pfm(d / "sky.pfm", rng, 8, 16)
    write_pfm(d / "gray.pfm", rng, 4, 6, colour=False, little=False)
    np.save(d / "map.npy", rng.uniform(0, 1, (4, 4, 3)).astype(np.float32))
    (d / "lens.dat").write_text(LENS)
    spd = np.stack([np.linspace(380, 720, 18), rng.uniform(0.2, 1.0, 18)], 1)
    (d / "light.spd").write_text("# lambda value\n" + "\n".join(f"{a} {b}" for a, b in spd))
    from rs_pbrt_tpu_torch.tools import material_scenes as ms

    write_scatfun(d / "glossy.bsdf", ms.glossy_fourier_table(n_mu=12))


def snippets(d: Path) -> dict:
    """name -> (scene text, overrides) of the snippet cases; d holds the
    files of write_assets (an .spd file is read from the path in the
    text, as the reference reads it)."""
    spd = d / "light.spd"
    cases = {}
    cases["shapes"] = (HEAD + """Sampler "stratified" "integer pixelsamples" 4
WorldBegin
CoordinateSystem "origin"
AttributeBegin
  Material "matte" "rgb Kd" [0.4 0.5 0.6] "float sigma" 20
  Translate 0 -1 0
  Rotate 30 0 1 0
  Scale 2 1 2
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]
    "normal N" [0 1 0  0.1 1 0  0 1 0.1  -0.1 1 0]
    "float uv" [0 0  1 0  1 1  0 1]
AttributeEnd
AttributeBegin
  Transform 1 0 0 0  0 1 0 0  0 0 1 0  0.5 0.25 0 1
  ConcatTransform 0 1 0 0  -1 0 0 0  0 0 1 0  0 0 0 1
  Shape "plymesh" "string filename" "mesh_ascii.ply"
AttributeEnd
AttributeBegin
  ReverseOrientation
  Scale -1 1 1
  Shape "plymesh" "string filename" "mesh_le.ply"
AttributeEnd
TransformBegin
  Translate 0 3 0
  Shape "plymesh" "string filename" "mesh_be.ply"
  CoordinateSystem "up"
TransformEnd
Shape "loopsubdiv" "integer levels" 2 "integer indices" [0 1 2  0 2 3  0 3 1  1 3 2]
  "point P" [0 0 0  1 0 0  0 1 0  0 0 1]
Shape "loopsubdiv" "integer nlevels" 1 "integer indices" [0 1 2  0 2 3]
  "point P" [0 0 0  1 0 0  1 1 0.2  0 1 0]
Shape "nurbs" "integer nu" 4 "integer nv" 3 "integer uorder" 3 "integer vorder" 2
  "float uknots" [0 0 0 0.5 1 1 1] "float vknots" [0 0 0.5 1 1]
  "point P" [0 0 0  1 0 0.5  2 0 0  3 0 0.2  0 1 0  1 1 1  2 1 0  3 1 0.3
             0 2 0  1 2 0.4  2 2 0.1  3 2 0]
Shape "nurbs" "integer nu" 3 "integer nv" 3 "integer uorder" 3 "integer vorder" 3
  "float uknots" [0 0 0 1 1 1] "float vknots" [0 0 0 1 1 1]
  "float Pw" [0 0 0 1  1 0 1 0.7  2 0 0 1  0 1 1 1  1 1 2 0.5  2 1 1 1
              0 2 0 1  1 2 1 0.8  2 2 0 1]
CoordSysTransform "up"
Shape "sphere" "float radius" 0.5 "float zmin" -0.3 "float zmax" 0.4 "float phimax" 270
Shape "sphere"
Shape "cylinder" "float radius" 0.3 "float zmin" -0.5 "float zmax" 0.8 "float phimax" 300
Shape "disk" "float height" 0.2 "float radius" 0.6 "float innerradius" 0.1
Shape "paraboloid" "float radius" 0.5 "float height" 0.7
Shape "cone" "float radius" 0.4 "float height" 0.9
Shape "hyperboloid" "float radius" 0.3 "float height" 0.5
CoordSysTransform "origin"
Identity
Shape "heightfield" "integer nu" 4 "integer nv" 3
  "float Pz" [0 0.1 0.2 0  0.3 0.5 0.1 0  0 0.2 0.1 0]
Shape "heightfield" "integer nu" 1 "integer nv" 3 "float Pz" [0 0 0]
Shape "curve" "string type" "ribbon" "float width0" 0.05 "float width1" 0.02
  "point P" [0 0 0  1 0.5 0  2 0 0  3 0.5 0  4 0 0  5 0.5 0  6 0 0]
  "normal N" [0 0 1  0 1 1  1 0 1]
Shape "curve" "string type" "cylinder" "float width" 0.1 "integer splitdepth" 2
  "point P" [0 0 1  1 1 1  2 0 1  3 1 1]
Shape "curve" "point P" [0 0 2  1 1 2  2 0 2  3 1 2]
Shape "torus"
WorldEnd
""", None)
    cases["materials"] = (HEAD + f"""WorldBegin
MakeNamedMaterial "m_matte" "string type" "matte" "rgb Kd" [0.2 0.3 0.4]
MakeNamedMaterial "m_plastic" "string type" "plastic" "rgb Kd" [0.1 0.2 0.3]
  "rgb Ks" [0.4 0.4 0.4] "float roughness" 0.05 "bool remaproughness" "false"
MakeNamedMaterial "m_mix" "string type" "mix" "string namedmaterial1" "m_matte"
  "string namedmaterial2" "m_plastic" "rgb amount" [0.3 0.5 0.7]
MakeNamedMaterial "m_badmix" "string type" "mix" "string namedmaterial1" "nothing"
Material "mirror" "rgb Kr" [0.8 0.85 0.9]
Material "glass" "float index" 1.33 "rgb Kr" [1 0.9 0.8]
Material "glass" "float eta" 1.7 "float uroughness" 0.2
Material "glass" "float roughness" 0.1 "rgb Kt" [0.5 0.6 0.7]
Material "metal"
Material "metal" "rgb eta" [0.2 0.9 1.1] "spectrum k" [400 3.9 550 2.4 700 2.1]
  "float roughness" 0.3 "bool remaproughness" "true"
Material "substrate" "rgb Kd" [0.3 0.3 0.2] "rgb Ks" [0.1 0.1 0.1] "float uroughness" 0.2
Material "substrate"
Material "uber" "rgb Kd" [0.5 0.4 0.3] "rgb Kr" [0.1 0.1 0.1] "rgb Kt" [0.2 0.2 0.2]
  "float roughness" 0.2 "float eta" 1.4 "rgb opacity" [0.9 0.8 0.7]
Material "translucent" "rgb Kd" [0.6 0.5 0.4]
Material "hair" "rgb sigma_a" [0.3 0.5 0.9] "float beta_m" 0.25 "float alpha" 3
Material "hair" "rgb color" [0.4 0.2 0.1] "float eta" 1.6
Material "hair" "float eumelanin" 0.5 "float pheomelanin" 0.8 "float beta_n" 0.4
Material "hair"
Material "disney" "rgb color" [0.7 0.2 0.3] "float metallic" 0.4 "float roughness" 0.3
  "float sheen" 0.2 "float clearcoat" 0.5 "float eta" 1.45 "float speculartint" 0.1
  "float anisotropic" 0.3 "float spectrans" 0.2 "float clearcoatgloss" 0.7
  "bool thin" "true" "float flatness" 0.4 "float difftrans" 0.6 "float sheentint" 0.3
Material "subsurface" "string name" "Ketchup" "float scale" 2 "float eta" 1.4
Material "subsurface" "rgb sigma_a" [0.01 0.02 0.03] "rgb sigma_s" [1 2 3] "float g" 0.3
  "float uroughness" 0.1
Material "subsurface" "string name" "no such preset"
Material "fourier" "string bsdffile" "glossy.bsdf"
Material "fourier" "string bsdffile" "missing.bsdf"
Material "none"
Material ""
Material "unknownmaterial" "rgb Kd" [0.1 0.9 0.1]
NamedMaterial "m_mix"
{QUAD}
NamedMaterial "m_badmix"
NamedMaterial "nothing"
{QUAD}
WorldEnd
""", None)
    cases["textures"] = (HEAD + """WorldBegin
Texture "c" "spectrum" "constant" "rgb value" [0.2 0.4 0.6]
Texture "s" "spectrum" "scale" "texture tex1" "c" "rgb tex2" [0.5 0.5 0.5]
Texture "mx" "spectrum" "mix" "texture tex1" "c" "texture tex2" "s" "float amount" 0.25
Texture "ck" "spectrum" "checkerboard" "float uscale" 4 "float vscale" 2
  "rgb tex1" [1 0 0] "rgb tex2" [0 0 1] "float udelta" 0.1 "float vdelta" 0.2
Texture "dt" "spectrum" "dots" "texture inside" "ck" "rgb outside" [0.1 0.1 0.1]
Rotate 20 1 1 0
Translate 0.3 0 0
Texture "fb" "float" "fbm" "integer octaves" 4 "float roughness" 0.6
Texture "wr" "float" "wrinkled" "integer octaves" 3
Texture "mb" "spectrum" "marble" "integer octaves" 5 "float roughness" 0.4
  "float scale" 2 "float variation" 0.3
Texture "wd" "float" "windy"
Identity
Texture "uvt" "spectrum" "uv" "float uscale" 2
Texture "bl" "spectrum" "bilerp" "rgb v00" [0 0 0] "rgb v11" [1 1 0.5]
Texture "im8" "spectrum" "imagemap" "string filename" "rgb8.png" "string wrap" "clamp"
  "float scale" 2
Texture "im16" "spectrum" "imagemap" "string filename" "rgba16.png" "string wrap" "black"
Texture "impal" "spectrum" "imagemap" "string filename" "palette4.png"
Texture "imhdr" "spectrum" "imagemap" "string filename" "flat.hdr"
Texture "imrle" "spectrum" "imagemap" "string filename" "rle.hdr" "string wrap" "repeat"
Texture "impfm" "float" "imagemap" "string filename" "gray.pfm"
Texture "imnpy" "spectrum" "imagemap" "string filename" "map.npy"
Texture "imexr" "spectrum" "imagemap" "string filename" "missing.exr"
Texture "odd" "spectrum" "ptex"
Texture "alphatex" "float" "checkerboard" "float tex1" 1 "float tex2" 0
Material "matte" "texture Kd" "im8"
Material "plastic" "texture Kd" "mx" "texture Ks" "imhdr" "texture bumpmap" "mb"
Material "glass" "texture Kr" "dt" "texture Kt" "bl"
Material "uber" "texture Kd" "im16" "texture opacity" "uvt" "texture Ks" "imrle"
  "texture Kr" "wd"
Material "substrate" "texture Kd" "impal" "texture Kd" "nosuchtexture"
Material "disney" "texture color" "imnpy"
Material "mirror" "texture Kr" "impfm"
Material "matte" "texture Kd" "imexr" "texture bumpmap" "imexr"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1] "texture alpha" "alphatex"
  "texture shadowalpha" "ck"
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0  1 0 0  0 1 0]
  "float alpha" 0 "float shadowalpha" 0.5
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 1  1 0 1  0 1 1]
  "texture alpha" "nosuchtexture"
WorldEnd
""", None)
    cases["lights"] = (HEAD + f"""WorldBegin
LightSource "point" "point from" [0 3 0] "xyz I" [5 6 4] "rgb scale" [2 2 2]
AttributeBegin
  Translate 1 0 0
  LightSource "spot" "point from" [0 4 0] "point to" [0 0 0] "blackbody I" [3000 2]
    "float coneangle" 25 "float conedeltaangle" 4
  LightSource "distant" "point from" [1 1 1] "point to" [0 0 0] "spectrum L" [400 1 500 2 700 3]
AttributeEnd
LightSource "distant" "spectrum L" "{spd}"
LightSource "projection" "point from" [0 2 -1] "point to" [0 0 0] "rgb I" [1 2 3]
  "float fov" 30 "string mapname" "rgb8.png"
LightSource "projection" "rgb I" [1 1 1]
LightSource "goniometric" "point from" [1 2 0] "point to" [1 0 0] "rgb I" [4 5 6]
  "string mapname" "rle.hdr"
LightSource "goniometric" "string mapname" "missing.png"
Rotate -90 1 0 0
LightSource "infinite" "string mapname" "sky.pfm" "rgb L" [0.5 0.6 0.7] "blackbody scale" [6500]
Identity
LightSource "foo"
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 4] "bool twosided" "true" "rgb scale" [1 2 3]
  Translate 0 2 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 0 0.5  -0.5 0 0.5]
  Shape "sphere" "float radius" 0.25
  Shape "disk" "float radius" 0.3
  Shape "cylinder" "float radius" 0.1 "float zmin" 0 "float zmax" 0.5
  Shape "cone" "float radius" 0.2
AttributeEnd
{QUAD}
WorldEnd
""", None)
    # a textured sigma or roughness reaches the material's factory as the
    # texture's name: both packages raise ValueError
    for name, material in (("sigma", '"matte" "texture sigma" "fb"'),
                           ("roughness", '"plastic" "texture roughness" "fb"')):
        cases[f"textured_{name}"] = (HEAD + f"""WorldBegin
Texture "fb" "float" "fbm"
Material {material}
WorldEnd
""", None)
    cases["infinite_constant"] = (HEAD + f"""WorldBegin
LightSource "infinite" "rgb L" [0.3 0.3 0.35]
{QUAD}
WorldEnd
""", None)
    cases["media"] = ("""MakeNamedMedium "fog" "string type" "homogeneous"
  "rgb sigma_a" [0.1 0.2 0.3] "rgb sigma_s" [1 2 3] "float g" 0.4
MediumInterface "" "fog"
""" + HEAD + """Integrator "volpath" "integer maxdepth" 7
WorldBegin
MakeNamedMedium "milk" "string preset" "Skin1" "float scale" 3
MakeNamedMedium "odd" "string preset" "no such preset"
Translate 0.5 0 0
MakeNamedMedium "smoke" "string type" "heterogeneous" "integer nx" 3 "integer ny" 2
  "integer nz" 2 "point p0" [-1 0 -1] "point p1" [1 1 2]
  "float density" [1 2 3 4 5 6 7 8 9 10 11 12] "float g" -0.2
MakeNamedMedium "badgrid" "string type" "heterogeneous" "integer nx" 2 "float density" [1]
Identity
AttributeBegin
  MediumInterface "milk" "fog"
  Shape "sphere" "float radius" 0.5
AttributeEnd
AttributeBegin
  MediumInterface "smoke" "nothing"
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0  1 0 0  0 1 0]
  MediumInterface "badgrid"
  Shape "disk"
AttributeEnd
""" + QUAD + """
WorldEnd
""", None)
    proto = "".join(f"AttributeBegin\n  Translate {3 * (i % 8)} 0 {3 * (i // 8)}\n"
                    f"  ObjectInstance \"ball\"\nAttributeEnd\n" for i in range(40))
    cases["instances"] = (HEAD + f"""WorldBegin
ObjectBegin "pair"
  Material "plastic"
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0  1 0 0  0 1 0]
    "normal N" [0 0 1  0 0 1  0 0 1]
  ReverseOrientation
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 1  1 0 1  0 1 1]
ObjectEnd
ObjectBegin "withsphere"
  Shape "sphere" "float radius" 0.2
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 2  1 0 2  0 1 2]
ObjectEnd
ObjectBegin "ball"
  Material "matte" "rgb Kd" [0.7 0.2 0.2]
  Shape "loopsubdiv" "integer levels" 3 "integer indices" [{ICOSA_F}] "point P" [{ICOSA_P}]
ObjectEnd
ObjectBegin "lamp"
  AreaLightSource "diffuse" "rgb L" [2 2 2]
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 3 0  1 3 0  0 3 1]
ObjectEnd
ObjectBegin "empty"
ObjectEnd
ObjectInstance "pair"
Translate 2 0 0
ObjectInstance "pair"
ObjectInstance "withsphere"
ObjectInstance "lamp"
ObjectInstance "empty"
ObjectInstance "undefined"
{proto}WorldEnd
""", None)
    cases["motion"] = (f"""TransformTimes 0 1
LookAt 0 2 -6  0 0.5 0  0 1 0
ActiveTransform EndTime
Translate 0.2 0 0
ActiveTransform All
Camera "perspective" "float fov" 45 "float shutteropen" 0.1 "float shutterclose" 0.7
Film "image" "integer xresolution" 16 "integer yresolution" 12
WorldBegin
AttributeBegin
  ActiveTransform StartTime
  Translate -0.3 0 0
  ActiveTransform EndTime
  Rotate 20 0 1 0
  ActiveTransform All
  Scale 1 1.5 1
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1] "normal N" [0 1 0  0 1 0  0 1 0  0 1 0]
    "float st" [0 0  1 0  1 1  0 1]
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0  1 0 0  0 1 0]
  Shape "plymesh" "string filename" "mesh_ascii.ply"
  Shape "sphere" "float radius" 0.3
  ActiveTransform EndTime
  Transform 1 0 0 0  0 1 0 0  0 0 1 0  0 0.5 0 1
  ActiveTransform StartTime
  Identity
  ActiveTransform All
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 1  1 0 1  0 1 1]
AttributeEnd
{QUAD}
WorldEnd
""", None)
    cam_body = f"WorldBegin\n{QUAD}\nWorldEnd\n"
    cases["camera_perspective_lens"] = ("""LookAt 0 2 -6  0 0.5 0  0 1 0
Camera "perspective" "float fov" 30 "float lensradius" 0.05 "float focaldistance" 5
  "float shutteropen" 0.2 "float shutterclose" 0.6
Film "image" "integer xresolution" 20 "integer yresolution" 10
""" + cam_body, None)
    cases["camera_orthographic"] = ("""Scale -1 1 1
LookAt 0 2 -6  0 0.5 0  0 1 0
Camera "orthographic" "float shutterclose" 0.5
Film "image" "integer xresolution" 12 "integer yresolution" 16
""" + cam_body, None)
    cases["camera_environment"] = ("""LookAt 0 1 0  0 1 1  0 1 0
Camera "environment"
Film "image" "integer xresolution" 32 "integer yresolution" 16
""" + cam_body, None)
    cases["camera_realistic"] = ("""LookAt 0 2 -6  0 0.5 0  0 1 0
Camera "realistic" "string lensfile" "lens.dat" "float aperturediameter" 8
  "float focusdistance" 4 "bool simpleweighting" "false"
Film "image" "integer xresolution" 16 "integer yresolution" 16 "float diagonal" 30
""" + cam_body, None)
    for name in ("sobol", "random", "lowdiscrepancy", "02sequence", "stratified", "halton",
                 "maxmindist", "unknownsampler"):
        cases[f"sampler_{name}"] = (HEAD + f'Sampler "{name}" "integer pixelsamples" 6\n'
                                    + cam_body, None)
    for name, extra in (("box", ""), ("triangle", ' "float xwidth" 1.5 "float ywidth" 1'),
                        ("gaussian", ' "float xwidth" 2.5 "float alpha" 3'),
                        ("mitchell", ' "float B" 0.5 "float C" 0.25'),
                        ("sinc", ' "float ywidth" 3 "float tau" 2'),
                        ("unknownfilter", "")):
        cases[f"filter_{name}"] = (HEAD + f'PixelFilter "{name}"{extra}\n' + cam_body, None)
    for key, name, params in (
            ("path_uniform", "path", '"integer maxdepth" 3 "float rrthreshold" 0.5 '
                                     '"string lightsamplestrategy" "uniform"'),
            ("path_power", "path", '"string lightsamplestrategy" "power"'),
            ("path_unknown_strategy", "path", '"string lightsamplestrategy" "nonsense"'),
            ("volpath", "volpath", '"integer maxdepth" 9'),
            ("whitted", "whitted", '"integer maxdepth" 2'),
            ("directlighting", "directlighting", '"string strategy" "one"'),
            ("ao", "ao", '"integer nsamples" 16 "bool cossample" "false"'),
            ("sppm", "sppm", '"integer numiterations" 4 "integer photonsperiteration" 512 '
                             '"float radius" 0.25 "integer maxdepth" 3'),
            ("sppm_iterations", "sppm", '"integer iterations" 2'),
            ("bdpt", "bdpt", '"bool visualizestrategies" "true" "integer maxdepth" 4'),
            ("mlt", "mlt", '"integer bootstrapsamples" 1000 "integer chains" 64 '
                           '"integer mutationsperpixel" 8 "float sigma" 0.02 '
                           '"float largestepprobability" 0.4')):
        cases[f"integrator_{key}"] = (HEAD + f'Integrator "{name}" {params}\n' + cam_body, None)
    cases["crop_accel_film"] = ("""LookAt 0 2 -6  0 0.5 0  0 1 0
Camera "perspective"
Film "image" "integer xresolution" 40 "integer yresolution" 30
  "float cropwindow" [0.25 0.75 0.1 0.6] "string filename" "out.png"
Accelerator "kdtree"
""" + cam_body, None)
    cases["overrides"] = (HEAD + 'Sampler "halton" "integer pixelsamples" 6\n'
                          + 'Integrator "path"\n' + cam_body,
                          {"samples": 3, "integrator": "volpath"})
    cases["include"] = (HEAD + f'WorldBegin\nInclude "inc/part.pbrt"\nWorldEnd\n', None)
    (d / "inc").mkdir(exist_ok=True)
    (d / "inc" / "part.pbrt").write_text(
        'Material "matte" "rgb Kd" [0.1 0.2 0.3]\n' + QUAD + "\n"
        'Include "more.pbrt"\n')
    (d / "inc" / "more.pbrt").write_text('Shape "sphere" "float radius" 0.7\n')
    return cases
