"""Image output (host-side): linear RGB -> sRGB u8 -> PNG.

The port of ``_to_srgb_u8`` and ``write_png`` from the JAX package's
``io/image.py`` (reference film.rs:438-528).  The PNG is written with zlib
alone, so the port needs no imaging library.
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
