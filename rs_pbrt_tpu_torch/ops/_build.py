"""Builds the CUDA sources of ``csrc/`` on first use and loads them.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with ctypes.  All
sources build in parallel, one ``nvcc`` each, into
``rs_pbrt_tpu_torch/_build/<hash>/``; the hash covers every source and
header and the flags, so an edited source builds anew and an unchanged one
is loaded as it is.

``--fmad=false`` keeps ``a*b + c`` as a rounded multiply and a rounded add,
as the plain PyTorch versions compute it, so the kernels can be held to
them at tight tolerances; no ``--use_fast_math``, so division, ``sqrtf``,
``sinf`` and ``cosf`` stay IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_libs: dict = {}  # loaded libraries, by source name


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all(verbose: bool = False) -> Path:
    """Compile every csrc/*.cu that is not built yet; returns the directory.
    verbose adds ``-Xptxas -v`` and prints each kernel's registers."""
    out = BUILD / _digest()
    todo = [s for s in sorted(CSRC.glob("*.cu")) if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
            continue
        if verbose and log:
            print(log, end="")
        os.replace(tmp, out / f"lib{src.stem}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        _libs[name] = lib
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
