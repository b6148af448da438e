"""W1: the multiple-importance weight of one BDPT strategy, the kernel's
wrapper and its plain version.

The port of the JAX package's ``_mis_weight``
(models/integrators/bdpt.py:465, reference bdpt.rs mis_weight :1505), an
XLA loop: for strategy (s, t) it walks the camera subpath from vertex t-1
down to 1 and the light subpath from s-1 down to 0, multiplying the ratio
remap0(pdf_rev) / remap0(pdf_fwd) into a running product ri and adding ri
to sum_ri wherever neither the vertex nor its neighbour toward the
endpoint is delta; the weight is 1 / (1 + sum_ri), and 1 where s + t == 2.

Inputs: the two subpaths' pdf_fwd and pdf_rev (D, N) f32 and delta (D, N)
bool columns, slot-major as ``models/integrators/bdpt.Subpath`` stores
them; the strategy's endpoint overrides (the reference's ScopedAssignment
temporaries) as a tuple in OVERRIDES' order, each an (N,) tensor or None
(``overrides`` builds it from the JAX-style dict keyed (side, slot,
field)); l0_is_delta (N,) bool or None, the light origin's delta test.
``mis_weight`` launches the CUDA kernel (``csrc/mis.cu``) for CUDA tensors
and runs ``mis_weight_plain`` for CPU tensors; both compute each product
as (ri * a) / b and each sum in the JAX order, so they agree bit for bit
(the kernel is built with --fmad=false).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build

# the override slots: c[t-1].pdf_rev, c[t-2].pdf_rev, l[s-1].pdf_rev,
# l[s-2].pdf_rev, l[0].pdf_fwd, l[0].pdf_rev, l[0].delta
OVERRIDES = ("c1_rev", "c2_rev", "l1_rev", "l2_rev", "l0_fwd", "l0_rev", "l0_delta")
launches = 0  # kernel launches of `mis_weight`; the plain path does not count


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("mis").rs_mis_weight
    P, I = ctypes.c_void_p, ctypes.c_int
    # c_fwd, c_rev, c_delta, l_fwd, l_rev, l_delta, ov[6], ov_l0_delta, l0_is_delta, out, n,
    # dc, dl, s, t, stream
    fn.argtypes = [P, P, P, P, P, P, ctypes.POINTER(P), P, P, P, ctypes.c_longlong, I, I, I, I,
                   P]
    fn.restype = ctypes.c_int
    return fn


def overrides(s: int, t: int, ov: dict) -> tuple:
    """The OVERRIDES tuple of a JAX-style override dict {(side, slot,
    field): (N,) tensor}, side "c" or "l", field "pdf_rev", "pdf_fwd" or
    "delta"; raises on a key the strategy's endpoints do not hold."""
    out = [None] * len(OVERRIDES)
    for (side, slot, name), v in ov.items():
        if side == "c" and name == "pdf_rev" and slot in (t - 1, t - 2):
            k = 0 if slot == t - 1 else 1
        elif side == "l" and name == "pdf_rev" and slot in (s - 1, s - 2, 0):
            k = 2 if slot == s - 1 else 3 if slot == s - 2 else 5
        elif side == "l" and slot == 0 and name in ("pdf_fwd", "delta"):
            k = 4 if name == "pdf_fwd" else 6
        else:
            raise ValueError(f"mis_weight: no override {side}[{slot}].{name} at (s, t) = "
                             f"({s}, {t})")
        out[k] = v
    return tuple(out)


def _remap0(x):
    """bdpt.rs remap0: 0 -> 1 for the ratio products (the JAX _remap0)."""
    return torch.where(x > 0.0, x, 1.0)


def mis_weight_plain(c_fwd, c_rev, c_delta, l_fwd, l_rev, l_delta, s: int, t: int, ov: tuple,
                     l0_is_delta=None) -> torch.Tensor:
    """W1's plain version: the JAX _mis_weight's loops op by op."""
    n, dev = c_fwd.shape[1], c_fwd.device
    if s + t == 2:
        return torch.ones(n, device=dev)
    c1, c2, l1, l2, l0f, l0r, l0d = ov

    def c_rev_at(i):
        if i == t - 1 and c1 is not None:
            return c1
        if i == t - 2 and c2 is not None:
            return c2
        return c_rev[i]

    def l_rev_at(i):
        for slot, v in ((s - 1, l1), (s - 2, l2), (0, l0r)):
            if i == slot and v is not None:
                return v
        return l_rev[i]

    def l_delta_at(i):
        return l0d if i == 0 and l0d is not None else l_delta[i]

    sum_ri = torch.zeros(n, device=dev)
    ri = torch.ones(n, device=dev)
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(c_rev_at(i)) / _remap0(c_fwd[i])
        cv0 = c_delta[i - 1] if i - 1 >= 1 else torch.zeros(n, dtype=torch.bool, device=dev)
        sum_ri = sum_ri + torch.where(~c_delta[i] & ~cv0, ri, 0.0)
    ri = torch.ones(n, device=dev)
    if l0_is_delta is None:
        l0_is_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(s - 1, -1, -1):
        fwd = l0f if i == 0 and l0f is not None else l_fwd[i]
        ri = ri * _remap0(l_rev_at(i)) / _remap0(fwd)
        prev = l_delta_at(i - 1) if i > 0 else l0_is_delta
        sum_ri = sum_ri + torch.where(~l_delta_at(i) & ~prev, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def _check_args(c_fwd, c_rev, c_delta, l_fwd, l_rev, l_delta, s, t, ov, l0_is_delta):
    """Raises on what the kernel does not take, on any device."""
    dc, n = c_fwd.shape
    dl = l_fwd.shape[0]
    for name, x, dtype, shape in (
            ("c_fwd", c_fwd, torch.float32, (dc, n)), ("c_rev", c_rev, torch.float32, (dc, n)),
            ("c_delta", c_delta, torch.bool, (dc, n)), ("l_fwd", l_fwd, torch.float32, (dl, n)),
            ("l_rev", l_rev, torch.float32, (dl, n)), ("l_delta", l_delta, torch.bool, (dl, n)),
            *((OVERRIDES[k], v, torch.bool if k == 6 else torch.float32, (n,))
              for k, v in enumerate(ov) if v is not None),
            *((("l0_is_delta", l0_is_delta, torch.bool, (n,)),) if l0_is_delta is not None
              else ())):
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != c_fwd.device:
            raise ValueError(f"mis_weight: {name} must be a {dtype} tensor of shape {shape} on "
                             f"{c_fwd.device}, not {x.dtype} {tuple(x.shape)} on {x.device}")
    if len(ov) != len(OVERRIDES) or not (1 <= t <= dc and 0 <= s <= dl):
        raise ValueError(f"mis_weight: strategy (s, t) = ({s}, {t}) outside subpaths of "
                         f"{dl} and {dc} vertices, or {len(ov)} overrides")


def mis_weight(c_fwd, c_rev, c_delta, l_fwd, l_rev, l_delta, s: int, t: int, ov: tuple,
               l0_is_delta=None) -> torch.Tensor:
    """(N,) f32 MIS weights of strategy (s, t) (see the module's
    docstring): the kernel for CUDA tensors, the plain version for CPU
    ones."""
    _check_args(c_fwd, c_rev, c_delta, l_fwd, l_rev, l_delta, s, t, ov, l0_is_delta)
    if c_fwd.device.type == "cpu":
        return mis_weight_plain(c_fwd, c_rev, c_delta, l_fwd, l_rev, l_delta, s, t, ov,
                                l0_is_delta)
    global launches
    if c_fwd.device.type != "cuda":
        raise ValueError(f"mis_weight: tensors lie on {c_fwd.device}")
    cols = [x.contiguous() for x in (c_fwd, c_rev, c_delta, l_fwd, l_rev, l_delta)]
    ovs = [None if v is None else v.contiguous() for v in ov]
    l0d = None if l0_is_delta is None else l0_is_delta.contiguous()
    ptr = lambda x: None if x is None else x.data_ptr()
    floats = (ctypes.c_void_p * 6)(*(ptr(v) for v in ovs[:6]))
    dc, n = c_fwd.shape
    out = torch.empty(n, dtype=torch.float32, device=c_fwd.device)
    with torch.cuda.device(c_fwd.device):
        err = _kernel()(*(x.data_ptr() for x in cols), floats, ptr(ovs[6]), ptr(l0d),
                        out.data_ptr(), n, dc, l_fwd.shape[0], s, t,
                        torch.cuda.current_stream(c_fwd.device).cuda_stream)
    _build.check(err, "mis_weight kernel launch")
    launches += 1
    return out
