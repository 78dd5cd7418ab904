"""K3: fused dedup + retention priority for fixed-capacity slab compaction.

Port of ``repro/kernels/compact.py``. Compacting S^(F) ∪ Z into
``capacity`` slots is a selection: every entry gets a retention priority
(members by weight descending, then aux, dropped/duplicate/empty +inf) and
the ``capacity`` smallest priorities are taken with K2. The kernel is
``csrc/compact.cu``; ``retention_priority_plain`` is its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._util import (check_cuda, kernel_lib, meta_call,
                                       on_meta, pad_tail, raise_on_error,
                                       stream_ptr)
from repro_torch.kernels.blockselect import (batched_bottomk_select,
                                             batched_bottomk_select_plain)


def retention_priority_plain(sorted_keys, weights, member, keep):
    """Plain PyTorch version of K3 (same arithmetic, any device)."""
    k = sorted_keys.to(torch.int32)
    prev = torch.cat([torch.full((1,), -2, dtype=torch.int32,
                                 device=k.device), k[:-1]])
    dup = (k == prev) | (k < 0)
    kp = keep.to(torch.bool) & ~dup
    w = torch.clamp_min(weights.to(torch.float32), 0.0)
    inv = 1.0 / (1.0 + w)
    pri = torch.where(member.to(torch.bool), inv, 2.0 + inv)
    return torch.where(kp, pri, torch.full_like(pri, float("inf")))


def retention_priority(sorted_keys, weights, member, keep):
    """Key-sorted (key asc, weight desc) entries -> priority f32 [n]:
    duplicates (all but a key's first entry), negative keys and entries
    with ``keep`` False get +inf; members 1/(1+w), aux 2 + 1/(1+w).
    CPU -> plain version; CUDA -> the kernel (counted in
    ``retention_priority.launches``)."""
    if sorted_keys.device.type == "cpu":
        return retention_priority_plain(sorted_keys, weights, member, keep)
    n = sorted_keys.shape[0]
    if on_meta(sorted_keys):        # shapes and bytes only
        return meta_call("compact", (sorted_keys, weights, member, keep), (
            torch.empty((n,), dtype=torch.float32, device="meta"),))[0]
    check_cuda("sorted_keys", sorted_keys, torch.int32, (n,))
    check_cuda("weights", weights, torch.float32, (n,))
    check_cuda("member", member, torch.bool, (n,))
    check_cuda("keep", keep, torch.bool, (n,))
    pri = torch.empty((n,), dtype=torch.float32, device=sorted_keys.device)
    if n == 0:
        return pri
    code = kernel_lib().repro_priority(
        sorted_keys.data_ptr(), member.data_ptr(), keep.data_ptr(),
        weights.data_ptr(), pri.data_ptr(), n,
        stream_ptr(sorted_keys.device))
    retention_priority.launches += 1
    raise_on_error("priority", code)
    return pri


retention_priority.launches = 0


def _take(pri: torch.Tensor, capacity: int, select):
    n = pri.shape[0]
    if n < capacity + 1:     # block-select needs >= capacity+1 candidates
        pri = pad_tail(pri, capacity + 1, float("inf"))
    vals, idx, _tau = select(pri[None, :], capacity)
    vals, idx = vals[0], idx[0]
    valid = torch.isfinite(vals) & (idx >= 0) & (idx < n)
    return torch.where(valid, idx, torch.full_like(idx, -1)), valid


def compact_take(sorted_keys, weights, member, keep, capacity: int):
    """Gather indices compacting retained entries into ``capacity`` slots.

    Returns (take int32 [capacity], taken_valid bool [capacity]): positions
    of the ``capacity`` highest-retention entries, -1 / False past the
    retained count. The take is K2's exact bottom-k over the priorities.
    """
    return _take(retention_priority(sorted_keys, weights, member, keep),
                 capacity, batched_bottomk_select)


def compact_take_plain(sorted_keys, weights, member, keep, capacity: int):
    """``compact_take`` through the plain versions of K3 and K2."""
    return _take(retention_priority_plain(sorted_keys, weights, member,
                                          keep),
                 capacity, batched_bottomk_select_plain)
