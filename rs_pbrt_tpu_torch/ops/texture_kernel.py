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

Where autograd records through the tables' params or atlas, the lookup is
``TextureFn``: its forward is the same launch on detached tables, its
backward ``texture_grad`` (T2, ``csrc/texture_grad.cu``, on CUDA tensors;
``texture_grad_plain`` on CPU ones), the vector-Jacobian product in
tex_params (X, 16) and tex_atlas (AH, AW, 3).  uv, p or width that carry a
gradient (a camera or geometry gradient on a textured surface) raise:
T2 does not differentiate in them (ROADMAP A17c).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .autodiff import A17C, tracks
from .texture import TexTables, eval_texture

# kernel launches of T1 and T2; the plain versions count none
launches = {"texture_eval": 0, "texture_grad": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("texture").rs_texture_eval
    # type, params, child, w2t, atlas, rect, mip, nlv, perm, n_tex, ah, aw,
    # kind_mask, ids, uv, p, width, n, rows, per_row, out, stream
    fn.argtypes = [_P] * 9 + [_I] * 4 + [_P] * 4 + [_I] * 3 + [_P, _P]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _grad_kernel():
    fn = _build.load("texture_grad").rs_texture_grad
    # T1's arguments without out, then g_out, g_params, g_atlas, stream
    fn.argtypes = [_P] * 9 + [_I] * 4 + [_P] * 4 + [_I] * 3 + [_P, _P, _P, _P]
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
    version on the CPU.  (S, N, 3).  Through TextureFn where autograd
    records through tb.params or tb.atlas."""
    if tracks(uv, p, width):
        raise NotImplementedError("texture_eval: T2 differentiates in the texture tables only; "
                                  f"gradients in uv, p and width come with {A17C}")
    if tracks(tb.params, tb.atlas):
        return TextureFn.apply(tb.params, tb.atlas, tb, ids, uv, p, width)
    return _eval(tb, ids, uv, p, width)


def _tables(tb: TexTables, ids, uv, p, width, what: str):
    """The launch's checked arguments: (ids (S, N) int32, uv, p, width,
    per_row), each contiguous."""
    ids = (ids if ids.dim() == 2 else ids[None]).to(torch.int32).contiguous()
    rows, n = ids.shape
    per_row = uv.dim() == 3
    uv, p = uv.contiguous(), p.contiguous()
    if rows * n >= (1 << 31) or tb.type.shape[0] >= (1 << 30):
        raise ValueError(f"{what}: {rows} x {n} lanes")
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
        raise ValueError(f"{what}: mip must hold 12 levels, not {tb.mip.shape[1]}")
    if width is not None:
        width = width.contiguous()
        _check("width", width, torch.float32, (n,))
    return ids, uv, p, width, per_row


def _table_ptrs(tb: TexTables) -> list:
    return [tb.type.data_ptr(), tb.params.data_ptr(), tb.child.data_ptr(), tb.w2t.data_ptr(),
            tb.atlas.data_ptr(), tb.rect.data_ptr(), tb.mip.data_ptr(), tb.nlv.data_ptr(),
            tb.perm.data_ptr(), tb.type.shape[0], tb.atlas.shape[0], tb.atlas.shape[1],
            tb.kind_mask]


def _eval(tb: TexTables, ids, uv, p, width=None):
    """T1's launch (the plain version on the CPU)."""
    if ids.device.type == "cpu":
        return plain(tb, ids, uv, p, width)
    ids, uv, p, width, per_row = _tables(tb, ids, uv, p, width, "texture_eval")
    rows, n = ids.shape
    out = torch.empty((rows, n, 3), dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        err = _kernel()(
            *_table_ptrs(tb), ids.data_ptr(), uv.data_ptr(), p.data_ptr(),
            None if width is None else width.data_ptr(), n, rows, int(per_row),
            out.data_ptr(), torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "texture_eval kernel launch")
    launches["texture_eval"] += 1
    return out


def texture_grad_plain(tb: TexTables, ids, uv, p, width, g_out):
    """T2's plain version: the vector-Jacobian product of the plain
    eval_texture at these lanes with g_out (S, N, 3), by autograd through
    its ops, in the tables' params and atlas -> (g_params (X, 16), g_atlas
    (AH, AW, 3))."""
    params = tb.params.detach().requires_grad_(True)
    atlas = tb.atlas.detach().requires_grad_(True)
    det = lambda t: None if t is None else t.detach()
    with torch.enable_grad():
        out = plain(tb._replace(params=params, atlas=atlas), ids, det(uv), det(p), det(width))
        gp, ga = torch.autograd.grad(out, [params, atlas], g_out.reshape(out.shape),
                                     allow_unused=True)
    return (torch.zeros_like(params) if gp is None else gp,
            torch.zeros_like(atlas) if ga is None else ga)


def texture_grad(tb: TexTables, ids, uv, p, width, g_out):
    """T2 for CUDA tensors, texture_grad_plain for CPU ones: (g_params
    (X, 16), g_atlas (AH, AW, 3)) of T1's lanes ids, uv, p, width with the
    upstream gradient g_out (S, N, 3)."""
    if ids.device.type == "cpu":
        return texture_grad_plain(tb, ids, uv, p, width, g_out)
    ids, uv, p, width, per_row = _tables(tb, ids, uv, p, width, "texture_grad")
    rows, n = ids.shape
    g_out = g_out.reshape(rows, n, 3).contiguous()
    _check("g_out", g_out, torch.float32, (rows, n, 3))
    g_params = torch.zeros_like(tb.params)
    g_atlas = torch.zeros_like(tb.atlas)
    with torch.cuda.device(ids.device):
        err = _grad_kernel()(
            *_table_ptrs(tb), ids.data_ptr(), uv.data_ptr(), p.data_ptr(),
            None if width is None else width.data_ptr(), n, rows, int(per_row),
            g_out.data_ptr(), g_params.data_ptr(), g_atlas.data_ptr(),
            torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "texture_grad kernel launch")
    launches["texture_grad"] += 1
    return g_params, g_atlas


class TextureFn(torch.autograd.Function):
    """T1's lookup, differentiable in the tables' params and atlas: forward
    T1 on detached tables, backward T2 (texture_grad)."""

    @staticmethod
    def forward(ctx, params, atlas, tb, ids, uv, p, width):
        tb = tb._replace(params=params.detach(), atlas=atlas.detach())
        ctx.tb, ctx.width = tb, width
        ctx.save_for_backward(ids, uv, p)
        return _eval(tb, ids, uv, p, width)

    @staticmethod
    def backward(ctx, g_out):
        ids, uv, p = ctx.saved_tensors
        g_params, g_atlas = texture_grad(ctx.tb, ids, uv, p, ctx.width, g_out)
        return (g_params if ctx.needs_input_grad[0] else None,
                g_atlas if ctx.needs_input_grad[1] else None, None, None, None, None, None)
