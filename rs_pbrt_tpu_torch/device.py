"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """torch.device for an entry point's ``device=`` argument.

    ``"cuda"`` (the default everywhere) means the current card and raises
    when there is none: the port never falls back to the CPU quietly.  The
    CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rs_pbrt_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
