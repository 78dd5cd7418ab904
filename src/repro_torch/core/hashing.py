"""Shared randomization u_x from a counter-based hash of (key, seed).

Port of ``repro/core/hashing.py``, bit-exact. PyTorch on the CPU has no
``>>`` for uint32, so the hash runs in int64 with ``& 0xFFFFFFFF`` after
every add and multiply: the low 32 bits survive int64 wrap-around, so the
result equals the uint32 arithmetic of the reference.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def _mix(h: torch.Tensor) -> torch.Tensor:
    """fmix32 finalizer from MurmurHash3 on int64 holding uint32 values."""
    h = h ^ (h >> 16)
    h = (h * _C1) & _M32
    h = h ^ (h >> 13)
    h = (h * _C2) & _M32
    return h ^ (h >> 16)


def _u32(x, device=None) -> torch.Tensor:
    """Integers (tensor, array or int) -> int64 tensor of their uint32
    values (negative int32 keys wrap as the reference's astype does)."""
    t = torch.as_tensor(x, device=device)
    return t.to(torch.int64) & _M32


def hash_u32(keys, seed=0) -> torch.Tensor:
    """uint32 hash of integer keys keyed by seed, as int64 in [0, 2^32).
    ``seed`` may be an int or an integer tensor broadcasting against keys."""
    k = _u32(keys)
    s = _u32(seed, device=k.device)
    h = _mix((k + _GOLDEN + s) & _M32)
    return _mix(h ^ ((s * _C1 + 1) & _M32))


def uniform01(keys, seed=0) -> torch.Tensor:
    """u_x in (0, 1): the top 24 hash bits as a float32 mantissa, shifted
    by half an ulp so u > 0 strictly."""
    h = hash_u32(keys, seed)
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u + (0.5 / (1 << 24))


def ppswor_rank(u) -> torch.Tensor:
    """r_x = -ln(1 - u_x): the Exp(1) rank of ppswor."""
    return -torch.log1p(-torch.as_tensor(u, dtype=torch.float32))


def rank_of(u, scheme: str) -> torch.Tensor:
    """r_x per bottom-k scheme: 'priority' -> u; 'ppswor' -> -ln(1-u)."""
    if scheme == "priority":
        return torch.as_tensor(u, dtype=torch.float32)
    if scheme == "ppswor":
        return ppswor_rank(u)
    raise ValueError(f"unknown scheme {scheme!r} (want 'priority' or "
                     f"'ppswor')")
