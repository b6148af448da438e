"""Builds the native sources of ``csrc/`` on first use and loads them.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``); each ``csrc/*.cpp`` (host
code, such as the BVH builder) one compiled by the host C++ compiler.  All
are loaded with ctypes.  Sources build in parallel, one compiler process
each, into ``rs_pbrt_tpu_torch/_build/<hash>/``; the hash covers every
source and header and the flags, so an edited source builds anew and an
unchanged one is loaded as it is.  ``load`` builds only the library it is
asked for, so the host builder builds where there is no CUDA toolkit.

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
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

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


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) found to build the BVH builder")


def _sources():
    """The libraries' sources: csrc/*.cu (nvcc) and csrc/*.cpp (host)."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cpp")])


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + CXX_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu*"), *CSRC.glob("*.cpp")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _command(src: Path, tmp: Path, verbose: bool) -> list:
    if src.suffix == ".cpp":
        return [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(src)]
    return [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
            "-I", str(CSRC), "-o", str(tmp), str(src)]


def build(names=None, verbose: bool = False) -> Path:
    """Compile the sources named (stems of csrc/ files; all when None) that
    are not built yet; returns the directory.  verbose adds ``-Xptxas -v``
    to nvcc and prints each kernel's registers."""
    out = BUILD / _digest()
    srcs = [s for s in _sources() if names is None or s.stem in names]
    if names is not None and len(srcs) != len(set(names)):
        raise ValueError(f"no source in {CSRC} for some of {sorted(names)}")
    todo = [s for s in srcs if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        procs.append((src, tmp, subprocess.Popen(
            _command(src, tmp, verbose), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"building {src.name} failed:\n{log}")
            continue
        if verbose and log:
            print(log, end="")
        os.replace(tmp, out / f"lib{src.stem}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_all(verbose: bool = False) -> Path:
    """Compile every source of csrc/ that is not built yet."""
    return build(None, verbose)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu or .cpp, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name]) / f"lib{name}.so"))
        _libs[name] = lib
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
