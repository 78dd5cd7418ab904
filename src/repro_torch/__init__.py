"""PyTorch/CUDA port of multi-objective weighted sampling: the serving
path, the metric tier and the universal-sample tier.

Mirrors the JAX package module for module (``core``, ``kernels``,
``launch``, ``ckpt``). Every kernel is hand-written CUDA C++ for Hopper
(``kernels/csrc``), built with ``nvcc`` at first launch; beside each sits
its plain PyTorch version, which runs for tensors on the CPU.

Device rule: entry points run on the card unless the caller passes
``device="cpu"``; given tensors, they follow the tensors' device
(``device_of``). A kernel wrapper dispatches on its input tensor's device:
CPU -> plain version, CUDA -> the kernel (or it raises).
"""
from __future__ import annotations

import numpy as np
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


def device_of(x, device=None) -> torch.device:
    """Where an entry point runs: ``device`` if given, else the device of a
    tensor input, else (host arrays) ``resolve_device(None)``."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(None)


def as_1d(x, dtype: torch.dtype, device) -> torch.Tensor:
    """Host array or tensor -> a contiguous 1-D tensor of ``dtype`` on
    ``device``."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(
            np.asarray(x).reshape(-1),
            dtype=np.dtype(str(dtype).replace("torch.", "")))
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x.reshape(-1).to(device=device, dtype=dtype).contiguous()


def lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort``: the last key is the primary sort key, the one
    before it breaks its ties, and so on; full ties keep index order.
    Stable sorts from the first key to the last."""
    order = torch.sort(keys[0], stable=True).indices
    for key in keys[1:]:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def keyed_inputs(keys, weights, active, device=None):
    """A keyed data set as the samplers take it: (keys int32, weights
    float32, active bool) 1-D tensors on ``device_of(keys, device)``."""
    dev = device_of(keys, device)
    return (as_1d(keys, torch.int32, dev), as_1d(weights, torch.float32, dev),
            as_1d(active, torch.bool, dev))
