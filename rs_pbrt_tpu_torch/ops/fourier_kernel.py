"""F1 and F2: the Fourier BSDF's evaluation and sampling, the kernels'
wrappers.

- F1, ``fourier_eval``: (f (N, 3), pdf (N,)), the JAX package's
  ``fourier_f`` and ``fourier_pdf`` (ops/fourier_bsdf.py:212 and :232) at
  (wo, wi) of the lanes of ``on``.
- F2, ``fourier_sample``: wi (N, 3), the direction its ``fourier_sample``
  (:249) draws at (wo, u2) on the lanes of ``on`` (its bsdf_sample reads
  only wi; f and pdf at wi are F1's).

Inputs: wo, wi or u2 (N, 3) / (N, 2) f32, on (N,) bool (the lanes whose
slot holds the Fourier lobe); the table is the scene's (FourierTable of
``ops/fourier_bsdf.table_of``).  Lanes off ``on`` get zeros.  On CUDA
tensors the wrappers launch the kernels of ``csrc/fourier.cu`` (one thread
a lane); on CPU tensors they run the plain versions
(``fourier_bsdf.fourier_eval_plain``, ``fourier_sample_plain``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .fourier_bsdf import M_CAP, FourierTable, fourier_eval_plain, fourier_sample_plain

launches = {"fourier_eval": 0, "fourier_sample": 0}  # kernel launches; the plain versions count none

_P, _I = ctypes.c_void_p, ctypes.c_int


@lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("fourier")
    ev, sm = lib.rs_fourier_eval, lib.rs_fourier_sample
    # mu, dense, m, cdf, a0, n_mu, eta, wo, wi or u2, on, n, out f and pdf or wi, stream
    ev.argtypes = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P]
    sm.argtypes = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P]
    ev.restype = sm.restype = ctypes.c_int
    return ev, sm


def _check(what, name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def _check_inputs(what, ft: FourierTable, wo, w, w_cols, on):
    n, MU = wo.shape[0], ft.mu.shape[0]
    if not 4 <= MU <= 1024 or n >= (1 << 31):
        raise ValueError(f"{what}: {MU} nodes, {n} lanes")
    for name, t, dtype, shape in (
            ("mu", ft.mu, torch.float32, (MU,)),
            ("dense", ft.dense, torch.float32, (MU * MU, 3 * M_CAP)),
            ("m", ft.m, torch.int32, (MU * MU,)), ("cdf", ft.cdf, torch.float32, (MU, MU)),
            ("a0", ft.a0, torch.float32, (MU, MU)), ("eta", ft.eta, torch.float32, ()),
            ("wo", wo, torch.float32, (n, 3)),
            ("wi" if w_cols == 3 else "u2", w, torch.float32, (n, w_cols)),
            ("on", on, torch.bool, (n,))):
        _check(what, name, t, dtype, shape)


def _table_args(ft: FourierTable):
    return (ft.mu.data_ptr(), ft.dense.data_ptr(), ft.m.data_ptr(), ft.cdf.data_ptr(),
            ft.a0.data_ptr(), ft.mu.shape[0], ft.eta.data_ptr())


def fourier_eval(ft: FourierTable, wo, wi, on):
    """F1: (f (N, 3), pdf (N,)) on the lanes of on; the plain version on the
    CPU."""
    if wo.device.type == "cpu":
        return fourier_eval_plain(ft, wo, wi, on)
    wo, wi, on = wo.contiguous(), wi.contiguous(), on.contiguous()
    _check_inputs("fourier_eval", ft, wo, wi, 3, on)
    n = wo.shape[0]
    f = torch.empty((n, 3), dtype=torch.float32, device=wo.device)
    pdf = torch.empty(n, dtype=torch.float32, device=wo.device)
    with torch.cuda.device(wo.device):
        err = _kernels()[0](*_table_args(ft), wo.data_ptr(), wi.data_ptr(), on.data_ptr(), n,
                            f.data_ptr(), pdf.data_ptr(),
                            torch.cuda.current_stream(wo.device).cuda_stream)
    _build.check(err, "fourier_eval kernel launch")
    launches["fourier_eval"] += 1
    return f, pdf


def fourier_sample(ft: FourierTable, wo, u2, on):
    """F2: wi (N, 3) on the lanes of on; the plain version on the CPU."""
    if wo.device.type == "cpu":
        return fourier_sample_plain(ft, wo, u2, on)
    wo, u2, on = wo.contiguous(), u2.contiguous(), on.contiguous()
    _check_inputs("fourier_sample", ft, wo, u2, 2, on)
    n = wo.shape[0]
    wi = torch.empty((n, 3), dtype=torch.float32, device=wo.device)
    with torch.cuda.device(wo.device):
        err = _kernels()[1](*_table_args(ft), wo.data_ptr(), u2.data_ptr(), on.data_ptr(), n,
                            wi.data_ptr(), torch.cuda.current_stream(wo.device).cuda_stream)
    _build.check(err, "fourier_sample kernel launch")
    launches["fourier_sample"] += 1
    return wi
