"""T1: texture evaluation, the kernel's wrapper.

``texture_eval(tb, ids, uv, p, width=None)`` evaluates the JAX package's
``eval_texture`` (ops/texture.py:286) for each lane: ids (S, N) int32,
S rows of textures at the same N points, so that one launch serves a
shading step's bound slots, a bump map's three evaluations or an alpha
test's two masks; uv (N, 2) and p (N, 3) shared by the rows, or (S, N, 2)
and (S, N, 3); width (N,) the texture-space footprint, or None (level 0
without reading the pyramid).  Returns (S, N, 3) f32, zeros on lanes whose
id is negative.  On CUDA tensors it launches the kernel of
``csrc/texture.cu`` (one thread a lane, a switch on the lane's texture
type); on CPU tensors it runs the plain version,
``ops/texture.eval_texture``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .texture import TexTables, eval_texture

launches = {"texture_eval": 0}  # kernel launches; the plain version counts none

_P, _I = ctypes.c_void_p, ctypes.c_int


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("texture").rs_texture_eval
    # type, params, child, w2t, atlas, rect, mip, nlv, perm, n_tex, ah, aw,
    # kind_mask, ids, uv, p, width, n, rows, per_row, out, stream
    fn.argtypes = [_P] * 9 + [_I] * 4 + [_P] * 4 + [_I] * 3 + [_P, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"texture_eval: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"texture_eval: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def plain(tb: TexTables, ids, uv, p, width=None):
    """The plain version at the wrapper's shapes: (S, N, 3)."""
    ids2 = ids if ids.dim() == 2 else ids[None]
    return eval_texture(tb, ids2, uv, p, width)


def texture_eval(tb: TexTables, ids, uv, p, width=None):
    """T1 on the lanes ids (S, N) (a (N,) ids is one row); the plain
    version on the CPU.  (S, N, 3)."""
    if ids.device.type == "cpu":
        return plain(tb, ids, uv, p, width)
    ids = (ids if ids.dim() == 2 else ids[None]).to(torch.int32).contiguous()
    rows, n = ids.shape
    per_row = uv.dim() == 3
    uv, p = uv.contiguous(), p.contiguous()
    if rows * n >= (1 << 31) or tb.type.shape[0] >= (1 << 30):
        raise ValueError(f"texture_eval: {rows} x {n} lanes")
    lead = (rows, n) if per_row else (n,)
    X = tb.type.shape[0]
    ah, aw = tb.atlas.shape[0], tb.atlas.shape[1]
    for name, t, dtype, shape in (
            ("type", tb.type, torch.int32, (X,)), ("params", tb.params, torch.float32, (X, 16)),
            ("child", tb.child, torch.int32, (X, 2)), ("w2t", tb.w2t, torch.float32, (X, 4, 4)),
            ("atlas", tb.atlas, torch.float32, (ah, aw, 3)),
            ("rect", tb.rect, torch.int32, (X, 4)),
            ("mip", tb.mip, torch.int32, (X, tb.mip.shape[1], 3)),
            ("nlv", tb.nlv, torch.int32, (X,)), ("perm", tb.perm, torch.int32, (512,)),
            ("ids", ids, torch.int32, (rows, n)), ("uv", uv, torch.float32, lead + (2,)),
            ("p", p, torch.float32, lead + (3,))):
        _check(name, t, dtype, shape)
    if tb.mip.shape[1] != 12:
        raise ValueError(f"texture_eval: mip must hold 12 levels, not {tb.mip.shape[1]}")
    if width is not None:
        width = width.contiguous()
        _check("width", width, torch.float32, (n,))
    out = torch.empty((rows, n, 3), dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        err = _kernel()(
            tb.type.data_ptr(), tb.params.data_ptr(), tb.child.data_ptr(), tb.w2t.data_ptr(),
            tb.atlas.data_ptr(), tb.rect.data_ptr(), tb.mip.data_ptr(), tb.nlv.data_ptr(),
            tb.perm.data_ptr(), X, ah, aw, tb.kind_mask, ids.data_ptr(), uv.data_ptr(),
            p.data_ptr(), None if width is None else width.data_ptr(), n, rows, int(per_row),
            out.data_ptr(), torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "texture_eval kernel launch")
    launches["texture_eval"] += 1
    return out
