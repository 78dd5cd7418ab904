"""K4: B segment predicates x |F| objectives over one slab, one launch.

Port of ``repro/kernels/segquery.py``: HT contributions f_j(w) / p over
member slots, contracted against the predicate selection [B, c] (range /
bitmask / hash31 fraction) -> estimates [F, B] in IEEE fp32. The kernel is
``csrc/segquery.cu``; ``segment_query_slab_plain`` is its plain version.
``launch_plan`` splits the slab into slices, one block each, from c
alone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.predicates import PRED_COLS, predicate_matrix
from repro_torch.kernels._util import (check_cuda, kernel_lib, meta_call,
                                       objective_arrays, on_meta,
                                       raise_on_error, stream_ptr,
                                       tile_tickets)
from repro_torch.kernels.seeds import fval

SLICE_TARGET = 512      # slots per slice the split aims at
MAX_SLICES = 16         # blocks a tile of predicates is split over
TILE_B = 16             # predicates per tile, one warp each


def launch_plan(c: int):
    """(slices, slice_len) of K4 over a slab of c slots.

    Up to MAX_SLICES slices of about SLICE_TARGET slots, one block each.
    Both numbers come from c alone, so a slot's place in the summation
    order, and an answer's bits, never depend on B.
    """
    slices = min(MAX_SLICES, max(1, -(-c // SLICE_TARGET)))
    return slices, -(-c // slices)


def segment_query_slab_plain(keys, weights, probs, member, table,
                             objectives):
    """Plain PyTorch version of K4: one fixed-order reduction per
    (objective, predicate) row."""
    w = weights.to(torch.float32)
    p = probs.to(torch.float32)
    ht = torch.where(member.to(torch.bool), 1.0 / torch.clamp_min(p, 1e-30),
                     torch.zeros_like(p))
    contrib = torch.stack([fval(k, prm, w) * ht for k, prm in objectives])
    sel = predicate_matrix(keys, table).to(torch.float32)
    return (contrib[:, None, :] * sel[None, :, :]).sum(-1)


def segment_query_slab(keys, weights, probs, member, table, objectives):
    """Slab fields [c] + int32 predicate table [B, PRED_COLS] -> estimates
    float32 [F, B]. CPU -> plain version; CUDA -> the kernel (counted in
    ``segment_query_slab.launches``)."""
    objectives = tuple((int(k), float(p)) for k, p in objectives)
    if table.shape[-1] != PRED_COLS or table.dim() != 2:
        raise ValueError(f"predicate table must be [B, {PRED_COLS}], "
                         f"got {tuple(table.shape)}")
    if keys.device.type == "cpu":
        return segment_query_slab_plain(keys, weights, probs, member, table,
                                        objectives)
    c = keys.shape[0]
    b = table.shape[0]
    if on_meta(keys):   # shapes, bytes and a multiply-add per
        return meta_call(            # (slot, predicate, objective)
            "segquery", (keys, weights, probs, member, table),
            (torch.empty((len(objectives), b), dtype=torch.float32,
                         device="meta"),), ops=2 * c * b * len(objectives))[0]
    check_cuda("keys", keys, torch.int32, (c,))
    check_cuda("weights", weights, torch.float32, (c,))
    check_cuda("probs", probs, torch.float32, (c,))
    check_cuda("member", member, torch.bool, (c,))
    check_cuda("table", table, torch.int32, (b, PRED_COLS))
    nf = len(objectives)
    out = torch.empty((nf, b), dtype=torch.float32, device=keys.device)
    if b == 0:
        return out
    kinds, params = objective_arrays(objectives)
    slices, slice_len = launch_plan(c)
    tiles = -(-b // TILE_B)
    # each block's [TILE_B, 8] partials (8: the most objectives)
    scratch = torch.empty(tiles * slices * TILE_B * 8, dtype=torch.float32,
                          device=keys.device)
    code = kernel_lib().repro_segquery(
        keys.data_ptr(), weights.data_ptr(), probs.data_ptr(),
        member.data_ptr(), table.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), tile_tickets(keys.device, tiles).data_ptr(), c,
        b, slices, slice_len, nf, ctypes.addressof(kinds),
        ctypes.addressof(params), stream_ptr(keys.device))
    segment_query_slab.launches += 1
    raise_on_error("segquery", code)
    return out


segment_query_slab.launches = 0
