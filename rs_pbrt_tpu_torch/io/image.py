"""Image IO (host-side): linear RGB -> sRGB u8 -> PNG, and the readers the
scene front end reaches for image maps, light maps and environment maps.

The port of the JAX package's ``io/image.py`` (reference film.rs:438-528
for the writer; textures/imagemap.rs and lights/infinite.rs load images).
PNG is written and read with zlib alone, so the port needs no imaging
library: the decoder takes non-interlaced PNGs of every colour type (grey,
grey and alpha, RGB, RGBA, palette) at bit depths 1-16 with all five row
filters, and keeps the RGB of what it reads as the JAX package's PIL
``convert("RGB")`` does (alpha dropped, a palette looked up, 16 bits
reduced to their high byte), before the same sRGB-to-linear step.
Radiance ``.hdr``, ``.pfm`` and ``.npy`` files are read as the JAX package
reads them.  EXR and the other formats come with ROADMAP A18b.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_srgb_u8(img) -> np.ndarray:
    """(H, W, 3) linear float -> sRGB u8, rounded to nearest."""
    img = np.asarray(img, np.float32)
    srgb = np.where(img <= 0.0031308, 12.92 * img,
                    1.055 * np.power(np.maximum(img, 1e-8), 1.0 / 2.4) - 0.055)
    return np.clip(srgb * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_png(path, img):
    """img: (H, W, 3) linear float (numpy or a torch tensor on any device)."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    px = to_srgb_u8(img)
    h, w, _ = px.shape
    raw = b"".join(b"\x00" + px[y].tobytes() for y in range(h))  # filter 0 per row

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def read_image(path) -> np.ndarray:
    """(H, W, 3) linear f32 RGB of the image at path: .hdr, .pfm and .npy
    by their extension, else a PNG (by its signature), its sRGB values
    taken to linear (the reference's inverse_gamma_correct on LDR loads)."""
    path = str(path)
    low = path.lower()
    if low.endswith(".hdr"):
        return read_hdr(path)
    if low.endswith(".pfm"):
        return read_pfm(path)
    if low.endswith(".npy"):
        return np.load(path).astype(np.float32)
    later = NotImplementedError(f"{path}: the port reads PNG, .hdr, .pfm and .npy images; "
                                "EXR and the other formats come with ROADMAP A18b")
    if low.endswith(".exr"):
        raise later
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise later
    im = decode_png(data).astype(np.float32) / 255.0
    return np.where(im <= 0.04045, im / 12.92,
                    np.power((im + 0.055) / 1.055, 2.4)).astype(np.float32)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) bytes of a non-interlaced PNG's scanlines, each row's
    filter (none, sub, up, average, Paeth) undone; bpp the bytes a pixel,
    at least 1."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        row = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1)
        if ftype == 0:
            cur = row.copy()
        elif ftype == 2:
            cur = row + prior
        elif ftype == 1:  # sub: a running sum along each byte of the pixel
            cur = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).ravel()
        elif ftype in (3, 4):
            cur = bytearray(row.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + up[x]) >> 1
                else:
                    b, c = up[x], (up[x - bpp] if x >= bpp else 0)
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a non-interlaced PNG: alpha dropped, a palette
    looked up, 16-bit samples reduced to their high byte, grey below 8 bits
    scaled to 0-255 (what PIL's convert("RGB") gives, but for 16-bit grey,
    which PIL clips at 255)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise NotImplementedError("interlaced PNG (Adam7) comes with ROADMAP A18b")
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"PNG: colour type {ctype} at bit depth {depth}")
    chans = _PNG_CHANNELS[ctype]
    bits = chans * depth
    stride = (w * bits + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, bits // 8))
    if depth == 16:
        px = rows.reshape(h, w, chans, 2)[..., 0]  # the high byte of each sample
    elif depth == 8:
        px = rows.reshape(h, w, chans)
    else:  # 1, 2 or 4 bits: one sample a pixel (grey or a palette index)
        px = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        px = (px * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(np.uint8)[..., None]
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: a palette image without PLTE")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_hdr(path) -> np.ndarray:
    """Radiance RGBE .hdr reader, flat and run-length-encoded scanlines
    (the reference reads it with the image crate's HdrDecoder,
    lights/infinite.rs:174)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = data.index(b"\n\n") if b"\n\n" in data else data.index(b"\r\n\r\n")
    rest = data[pos:].lstrip(b"\r\n")
    dim_end = rest.index(b"\n")
    dims = rest[:dim_end].decode().split()
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    raw = rest[dim_end + 1:]
    img = np.zeros((h, w, 4), np.uint8)
    off = 0
    for y in range(h):
        if raw[off:off + 2] == b"\x02\x02" and (raw[off + 2] << 8 | raw[off + 3]) == w:
            off += 4
            row = np.zeros((4, w), np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    n = raw[off]
                    off += 1
                    if n > 128:
                        row[c, x:x + n - 128] = raw[off]
                        off += 1
                        x += n - 128
                    else:
                        row[c, x:x + n] = np.frombuffer(raw[off:off + n], np.uint8)
                        off += n
                        x += n
            img[y] = row.T
        else:  # flat RGBE
            img[y] = np.frombuffer(raw[off:off + 4 * w], np.uint8).reshape(w, 4)
            off += 4 * w
    rgbe = img.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e.astype(np.int32) - 136), 0.0)
    return (rgbe[..., :3] * scale[..., None]).astype(np.float32)


def read_pfm(path) -> np.ndarray:
    """Portable float map (PF colour, Pf grey), rows bottom-up, the scale's
    sign giving the byte order."""
    with open(path, "rb") as f:
        kind = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        n_chan = 3 if kind == b"PF" else 1
        data = np.frombuffer(f.read(4 * w * h * n_chan), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, n_chan)[::-1]
    if n_chan == 1:
        img = np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img, np.float32)
