"""rs_pbrt_tpu_torch: the PyTorch/CUDA port of rs_pbrt_tpu.

A second package beside the JAX one.  Plain tensor code is PyTorch; each
Pallas kernel of the JAX package becomes a CUDA C++ kernel for Hopper
(``csrc/``), built on first use by ``ops/_build.py`` and bound with ctypes.
Beside every kernel sits a plain PyTorch version of the same function: a
kernel wrapper takes it only for CPU tensors.

Entry points take ``device=`` and default to ``"cuda"``; without a card they
raise instead of quietly running on the CPU (see ``device.resolve``).
"""
