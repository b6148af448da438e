"""PLY mesh loader (ASCII, binary little and big endian): the port's copy
of the JAX package's ``io/plyloader.py`` (reference src/shapes/plymesh.rs).
Host numpy; returns (V, F, N, UV), the faces triangulated as fans.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path):
    """(V (N, 3) f32, F (M, 3) int32, N (N, 3) f32 or None, UV (N, 2) f32 or
    None) of the PLY file at path."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise IOError(f"{path}: not a PLY file")
    end = data.index(b"end_header") + len(b"end_header")
    nl = data.index(b"\n", end)
    header = data[: nl].decode("ascii", "ignore")
    body = data[nl + 1 :]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_kind, dtype, name)])
    for line in header.splitlines():
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append(("list", (_TYPES[t[2]], _TYPES[t[3]]), t[4]))
            else:
                elements[-1][2].append(("scalar", _TYPES[t[1]], t[2]))

    endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    verts = {}
    faces = []

    if fmt == "ascii":
        toks = body.split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = {p[2]: np.zeros(count, np.float32) for p in props}
                for i in range(count):
                    for kind, dt, pname in props:
                        cols[pname][i] = float(toks[ti]); ti += 1
                verts = cols
            elif name == "face":
                for i in range(count):
                    for kind, dt, pname in props:
                        if kind == "list":
                            n = int(toks[ti]); ti += 1
                            idx = [int(toks[ti + k]) for k in range(n)]; ti += n
                            for k in range(1, n - 1):
                                faces.append((idx[0], idx[k], idx[k + 1]))
                        else:
                            ti += 1
            else:
                for i in range(count):
                    for kind, dt, pname in props:
                        if kind == "list":
                            n = int(toks[ti]); ti += 1 + n
                        else:
                            ti += 1
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] == "scalar" for p in props):
                dt = np.dtype([(p[2], endian + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                verts = {p[2]: arr[p[2]].astype(np.float32) for p in props}
            else:
                for i in range(count):
                    for kind, dt, pname in props:
                        if kind == "list":
                            cnt_dt = np.dtype(endian + dt[0])
                            n = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                            off += cnt_dt.itemsize
                            idx_dt = np.dtype(endian + dt[1])
                            idx = np.frombuffer(body, idx_dt, n, off).astype(np.int64)
                            off += idx_dt.itemsize * n
                            if name == "face":
                                for k in range(1, n - 1):
                                    faces.append((idx[0], idx[k], idx[k + 1]))
                        else:
                            sdt = np.dtype(endian + dt)
                            off += sdt.itemsize

    V = np.stack([verts["x"], verts["y"], verts["z"]], -1).astype(np.float32)
    N = None
    if "nx" in verts:
        N = np.stack([verts["nx"], verts["ny"], verts["nz"]], -1).astype(np.float32)
    UV = None
    for ux, uy in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ux in verts:
            UV = np.stack([verts[ux], verts[uy]], -1).astype(np.float32)
            break
    F = np.asarray(faces, np.int32).reshape(-1, 3)
    return V, F, N, UV
