"""K8: the MoE's slot count on the card.

Replaces no TPU kernel: the reference's slot assignment
(``repro/models/moe.py``, "slot assignment") is plain JAX, the running
count of a row's earlier choices of the same expert as a cumsum of a
[B, S*k, E] one-hot. ``expert_slots_plain`` is that arithmetic; CPU and
meta tensors take it (the CPU parity tests, the dry run's cost model).
CUDA tensors launch ``csrc/moe_slots.cu`` (or raise): a warp ranks 32
choices at a time by ``__match_any_sync``, a block scans its 8 warps per
expert, and a tile's base per expert is the sum of the row's earlier
tiles' counts (a count pass first where a row has more than one tile).
The outputs are integers, equal to the plain version's to the bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._util import (check_cuda, kernel_lib,
                                       raise_on_error, stream_ptr)
from repro_torch.telemetry import spans

THREADS = 256                # a block: 8 warps
TILES_PER_ROW = 32           # the tile count a row is cut into, at most ...
MAX_TILE = 8192              # ... until tiles reach this many choices
MAX_EXPERTS = 1024           # the kernel's shared counts: 8 x E int32


def expert_slots_plain(flat_e, E: int, C: int):
    """flat_e [B, n] int64 expert ids in [0, E) -> (slot, keep, dest)
    [B, n]: the number of the row's earlier choices of the same expert
    (int64), slot < C, and flat_e * C + slot where kept, else the drop
    row E * C (int64)."""
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=1) - 1        # [B,n,E]
    slot = torch.gather(pos, -1, flat_e[..., None])[..., 0]
    keep = slot < C
    dest = torch.where(keep, flat_e * C + slot, E * C)         # E*C: drop
    return slot, keep, dest


def slot_tile(n: int) -> int:
    """Choices a block takes in a row of n: a power of two from 256 to
    MAX_TILE, about n / TILES_PER_ROW (a row of n <= 256 is one tile)."""
    tile = THREADS
    while tile < MAX_TILE and tile * TILES_PER_ROW < n:
        tile *= 2
    return tile


def expert_slots_kernel(flat_e, E: int, C: int):
    """K8 on a CUDA flat_e [B, n] int64 -> (slot, keep, dest) as
    ``expert_slots_plain``. One call is one or two launches (a count pass
    where n > the tile), counted once in ``expert_slots.launches`` and in
    the recorder's ``moe.slots_kernel`` counter."""
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"moe_slots kernel: {E} experts, the kernel takes "
                         f"1..{MAX_EXPERTS}")
    if flat_e.ndim != 2:
        raise ValueError(f"moe_slots kernel: flat_e must be [B, n], got "
                         f"{tuple(flat_e.shape)}")
    B, n = flat_e.shape
    if B > 65535 or n >= 2 ** 31:
        raise ValueError(f"moe_slots kernel: [{B}, {n}] is over [65535, "
                         "2^31)")
    if not 0 <= C < 2 ** 31:
        raise ValueError(f"moe_slots kernel: capacity {C}")
    flat_e = check_cuda("moe_slots", flat_e.contiguous(), torch.int64)
    slot = torch.empty_like(flat_e)
    dest = torch.empty_like(flat_e)
    keep = torch.empty(flat_e.shape, dtype=torch.bool, device=flat_e.device)
    if not flat_e.numel():
        return slot, keep, dest
    tile = slot_tile(n)
    tiles = -(-n // tile)
    counts = (torch.empty((B, tiles, E), dtype=torch.int32,
                          device=flat_e.device) if tiles > 1 else None)
    code = kernel_lib().repro_moe_slots(
        flat_e.data_ptr(), None if counts is None else counts.data_ptr(),
        slot.data_ptr(), keep.data_ptr(), dest.data_ptr(), B, n, E, C, tile,
        stream_ptr(flat_e.device))
    expert_slots.launches += 1
    spans.count("moe.slots_kernel", 1)
    raise_on_error("moe_slots", code)
    return slot, keep, dest


def expert_slots(flat_e, E: int, C: int):
    """(slot, keep, dest) of a row's flattened expert choices flat_e
    [B, n]: K8 on CUDA tensors, the plain version on any other."""
    if flat_e.device.type == "cuda":
        return expert_slots_kernel(flat_e, E, C)
    return expert_slots_plain(flat_e, E, C)


expert_slots.launches = 0
