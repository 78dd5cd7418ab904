"""PyTorch/CUDA port of the multi-objective weighted sampling serving path.

Mirrors the JAX package module for module (``core``, ``kernels``,
``launch``, ``ckpt``). Every main-path kernel is hand-written CUDA C++ for
Hopper (``kernels/csrc``), built with ``nvcc`` at first launch; beside each
sits its plain PyTorch version, which runs for tensors on the CPU.

Device rule: entry points run on the card unless the caller passes
``device="cpu"``. A kernel wrapper dispatches on its input tensor's device:
CPU -> plain version, CUDA -> the kernel (or it raises).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; raises when no card is present (the port
    never drops to the CPU unless asked)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
