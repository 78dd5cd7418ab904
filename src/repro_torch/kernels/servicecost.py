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

from typing import NamedTuple

import torch

from repro_torch.core.costs import (CostTable, encode_cost_queries,
                                    service_cost_values, table_to)
from repro_torch.core.estimators import estimate_many
from repro_torch.core.funcs import SUM
from repro_torch.kernels._util import (check_cuda, kernel_lib,
                                       raise_on_error, round_up, stream_ptr,
                                       tile_tickets)

SETS = 4                        # sets per tile, one warp each
THREADS = 32 * SETS
MAX_SLICES = 8                  # blocks a tile of sets is split over
SMEM_MAX = 232_448              # bytes of shared memory a block may use
POINT_BUDGET = 80 * 1024        # the staged point tiles' share of it
CENTER_BUDGET = 40 * 1024       # ... and the staged centers'


class LaunchPlan(NamedTuple):
    """One K5 launch: per tile of SETS sets, ``slices`` blocks over
    ``slice_len`` slots each, point tiles of 32 * ``rows`` slots in
    ``stages`` buffers, up to ``cpcap`` centers of a set staged at once,
    ``threads`` threads and ``smem`` bytes of shared memory per block."""
    slices: int
    slice_len: int
    rows: int
    stages: int
    cpcap: int
    threads: int
    smem: int


def supported(dim: int, cmax: int) -> bool:
    """Whether K5 takes sets of ``cmax`` centers in ``dim`` dimensions.

    The domain of K5's first, one-block-per-set layout: dim <= 639, and
    at each dim the Cmax whose transposed centers (Cmax rounded up to 8)
    fit in one block beside a tile of 2 x threads points, with threads the
    largest of 256, 128, 64, 32 whose tile fits in 160 KB. The tiled
    kernel streams centers in chunks and could take more; the domain is
    kept so that callers see the same errors.
    """
    xst = dim | 1
    threads = next((t for t in (256, 128, 64, 32)
                    if 2 * t * xst * 4 <= 160 * 1024), None)
    if threads is None:
        return False
    cp = round_up(cmax, 8)
    return 4 * (dim * cp + 2 * cp + 2 * threads * xst + 32) <= SMEM_MAX


def launch_plan(c: int, dim: int, cmax: int) -> LaunchPlan:
    """The K5 launch for a slab of c slots in dim dimensions.

    Every field comes from (c, dim) alone, never from Q or Cmax, so a
    set's slots are summed in the same order, with the same bits, whatever
    batch and Cmax padding it shares a launch with. ``cmax`` is only
    checked against ``supported``; raises ValueError outside it.
    """
    if not supported(dim, cmax):
        raise ValueError(f"servicecost: dim {dim} x Cmax {cmax} is outside "
                         f"the kernel's domain (dim <= 639; Cmax bounded "
                         f"by the shared memory of a block)")
    st = 4 * (-(-dim // 4) | 1)             # row stride: 4 x odd words

    def tile_bytes(rows):
        return 32 * rows * (st + 1) * 4     # points and their |x|^2
    rows, stages = next(((r, n) for n in (2, 1) for r in (4, 2, 1)
                         if n * tile_bytes(r) <= POINT_BUDGET), (1, 1))
    groups = CENTER_BUDGET // (SETS * 8 * (st + 2) * 4)
    cpcap = 8 * min(8, max(1, groups))
    smem = 4 * (stages * 32 * rows * (st + 1) + SETS * cpcap * (st + 2))
    if smem > SMEM_MAX:
        raise ValueError(f"servicecost: dim {dim} needs {smem} bytes of "
                         f"shared memory (> {SMEM_MAX})")
    slices = min(MAX_SLICES, max(1, -(-c // (32 * rows))))
    return LaunchPlan(slices, -(-c // slices), rows, stages, cpcap, THREADS,
                      smem)


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
    plan = launch_plan(c, dim, cmax)
    tiles = -(-qn // SETS)
    scratch = torch.empty(tiles * plan.slices * SETS, dtype=torch.float32,
                          device=dev)
    code = kernel_lib().repro_servicecost(
        points.data_ptr(), probs.data_ptr(), member.data_ptr(),
        None if point_weights is None else point_weights.data_ptr(),
        table.centers.data_ptr(), table.cvalid.data_ptr(),
        table.mu.data_ptr(), table.param.data_ptr(), table.mode.data_ptr(),
        out.data_ptr(), scratch.data_ptr(),
        tile_tickets(dev, tiles).data_ptr(), c, dim, qn, cmax, plan.slices,
        plan.slice_len, plan.rows, plan.stages, plan.cpcap, plan.smem,
        stream_ptr(dev))
    service_cost_slab.launches += 1
    raise_on_error("servicecost", code)
    return out


service_cost_slab.launches = 0
