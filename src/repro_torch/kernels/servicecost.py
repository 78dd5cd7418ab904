"""K5: Q center sets x one sampled slab -> Q service-cost estimates, one launch.

Port of ``repro/kernels/servicecost.py``: for every set q and slab slot x,
d2 = (|c|^2 + |x|^2) - 2 x.c clamped at 0 over the set's valid centers,
the min over them, then d^mu (cost mode) or 1[d2 <= r^2] (ball mode),
non-finite -> 0, times the HT weight pw / p of member slots, summed over
the slab. The CUDA kernel is ``csrc/servicecost.cu``;
``service_cost_slab_plain`` is its plain PyTorch version
(``core.costs.service_cost_values`` followed by the HT sum), which runs
for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.costs import (CostTable, encode_cost_queries,
                                    service_cost_values, table_to)
from repro_torch.core.estimators import estimate_many
from repro_torch.core.funcs import SUM
from repro_torch.kernels._util import (check_cuda, kernel_lib,
                                       raise_on_error, round_up, stream_ptr)

THREAD_CHOICES = (256, 128, 64, 32)
SMEM_MAX = 232_448              # bytes of shared memory a block may use
XS_BUDGET = 160 * 1024          # the staged point tile's share of it


def launch_plan(dim: int, cmax: int):
    """(threads, shared-memory bytes) of one K5 block.

    The thread count depends on ``dim`` alone (the largest whose tile of
    2 * threads points fits the tile budget), so a set's answer has the
    same slot-to-thread assignment, and the same bits, whatever Cmax its
    batch is padded to. Raises if the centers do not fit beside the tile.
    """
    xst = dim | 1
    threads = next((t for t in THREAD_CHOICES
                    if 2 * t * xst * 4 <= XS_BUDGET), None)
    if threads is None:
        raise ValueError(f"servicecost: dim {dim} too large for the "
                         f"point tile ({XS_BUDGET} bytes)")
    cp = round_up(cmax, 8)
    smem = 4 * (dim * cp + 2 * cp + 2 * threads * xst + 32)
    if smem > SMEM_MAX:
        raise ValueError(f"servicecost: dim {dim} x Cmax {cmax} needs "
                         f"{smem} bytes of shared memory (> {SMEM_MAX})")
    return threads, smem


def service_cost_slab_plain(points, probs, member, table: CostTable,
                            point_weights=None) -> torch.Tensor:
    """Plain PyTorch version of K5: the [Q, c] value matrix, then one
    HT sum per row (``estimate_many`` with the values as the segment
    matrix). ``table`` holds tensors on the points' device."""
    pw = (torch.ones(points.shape[:1], dtype=torch.float32,
                     device=points.device)
          if point_weights is None else point_weights)
    values = service_cost_values(points, table)
    return estimate_many((SUM,), pw, probs, member, values)[0]


def service_cost_slab(points, probs, member, queries, point_weights=None):
    """Batched service-cost estimates over one sampled slab -> float32 [Q].

    points float32 [c, dim] (slot coordinates aligned with probs float32
    [c] and member bool [c]); queries: ServiceCostQuery batch or CostTable;
    point_weights: optional float32 [c]. CPU tensors take the plain
    version; CUDA tensors launch the kernel once for the whole batch
    (counted in ``service_cost_slab.launches``).
    """
    if not isinstance(points, torch.Tensor):
        raise TypeError("servicecost: points must be a tensor (its device "
                        "picks the kernel or the plain version)")
    if points.dim() != 2:
        raise ValueError(f"servicecost: points must be [c, dim], got "
                         f"{tuple(points.shape)}")
    dev = points.device
    table = table_to(encode_cost_queries(queries), dev)
    c, dim = points.shape
    qn, cmax, cdim = table.centers.shape
    if cdim != dim:
        raise ValueError(f"center dim {cdim} != point dim {dim}")
    if cmax == 0:
        raise ValueError("servicecost: center sets have no slots (Cmax 0)")
    if dev.type == "cpu":
        return service_cost_slab_plain(points, probs, member, table,
                                       point_weights)
    check_cuda("points", points, torch.float32, (c, dim))
    check_cuda("probs", probs, torch.float32, (c,))
    check_cuda("member", member, torch.bool, (c,))
    if point_weights is not None:
        check_cuda("point_weights", point_weights, torch.float32, (c,))
    out = torch.empty((qn,), dtype=torch.float32, device=dev)
    if qn == 0:
        return out
    threads, smem = launch_plan(dim, cmax)
    code = kernel_lib().repro_servicecost(
        points.data_ptr(), probs.data_ptr(), member.data_ptr(),
        None if point_weights is None else point_weights.data_ptr(),
        table.centers.data_ptr(), table.cvalid.data_ptr(),
        table.mu.data_ptr(), table.param.data_ptr(), table.mode.data_ptr(),
        out.data_ptr(), c, dim, qn, cmax, threads, smem, stream_ptr(dev))
    service_cost_slab.launches += 1
    raise_on_error("servicecost", code)
    return out


service_cost_slab.launches = 0
