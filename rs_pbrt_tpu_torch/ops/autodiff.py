"""Where the port's kernels meet autograd.

A kernel wrapper launches a CUDA kernel (or runs its plain version on the
CPU) on raw tensors: no gradient reaches its inputs through its outputs.
Each wrapper whose float output a differentiable leaf may reach either
takes its backward (K3/B1/D1 and V1 through G1, T1 through T2 and T3, R1
through R2, C1/C3 through C5, M2 through M3, M1 through a select:
``hit_grad_kernel``, ``texture_kernel``, ``splat_kernel``,
``curve_kernel``, ``medium_kernel``; L1 leaves its pose to PyTorch), or
calls ``refuse_grad`` where its route is chosen, so that a gradient never
vanishes without a word.  A wrapper whose only output is discrete (a hit
mask, a triangle id, a sampler's dims) takes its inputs detached.
"""

from __future__ import annotations

import torch

A17C = "ROADMAP A17c"


def tracks(*tensors) -> bool:
    """Whether autograd records through any of tensors (None and
    non-tensors skipped): grad mode on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)


def rows(table, idx):
    """table[idx] for row ids idx (N,), for a table that may carry a
    gradient: index_select, whose backward adds with index_add_ (the
    indexing operator's backward sorts the ids, which takes seconds on the
    card at 1M lanes of a few rows)."""
    return torch.index_select(table, 0, idx.long())


def refuse_grad(what: str, *tensors):
    """Raises NotImplementedError where a gradient would reach `what`'s
    inputs, whose backward the port does not have yet (ROADMAP A17c)."""
    if tracks(*tensors):
        raise NotImplementedError(
            f"{what} has no backward: gradients through it come with {A17C}")
