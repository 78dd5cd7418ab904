"""K2: bottom-k selection over [F, n] seed rows.

Port of ``repro/kernels/blockselect.py``, with two routes on the card:
  * the per-span route, the reference's API (``block_candidates``,
    ``batched_block_bottomk``, ``block_bottomk``; ``csrc/blockselect.cu``):
    per objective row and span of b <= 2048 slots, the k smallest seeds
    ascending, ties lowest index first, invalid = (+inf, -1). A span holds
    at most b entries, so the kernel writes kb = min(k, b) candidates per
    block; ``batched_block_bottomk`` pads them back to the reference's
    [F, nb * k] layout with (+inf, -1);
  * the global route behind ``batched_bottomk_select`` (``global_select``;
    ``csrc/select.cu``): each row's q = k + 1 smallest seeds found by radix
    passes over the whole row, written in index order and placed by their
    rank among the candidates. Its launches follow from (F, n, k) alone
    (``select_plan``).
The per-span route (and the global one past RANK_Q_MAX candidates) ends
in one stable sort over the candidates (``select_from_candidates``).
Candidates are index-ascending (per span, block-major), so the stable sort
gives the lowest-index-first tie order of ``lax.top_k``; the rank sort
breaks ties by index the same way. Both routes count in
``batched_block_bottomk.launches``.
Seeds are never NaN (the seeds kernel makes none); a NaN's place among
+inf padding is not specified.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels._util import (check_cuda, kernel_lib, meta_call,
                                       on_meta, pad_tail, raise_on_error,
                                       round_up, stream_ptr, tile_tickets)

BLOCK = 2048
SELECT_THREADS = 256        # select.cu: a block of 8 warps
SELECT_WARPS = SELECT_THREADS // 32
SELECT_BINS = 2048          # bins of select.cu's widest radix pass
TARGET_BLOCKS = 8 * 132     # eight 256-thread blocks per SM of an H100
MIN_CHUNK = 2048            # seeds a block of the global route reads at least
RANK_Q_MAX = 16384          # candidates select.cu's rank sort takes


def _span(n: int) -> int:
    """Block width: the streaming BLOCK, or the input rounded up to the
    128 quantum when smaller (the reference's block fit)."""
    return min(BLOCK, round_up(max(n, 1), 128))


def block_candidates_plain(seeds: torch.Tensor, k: int):
    """Plain PyTorch version of K2: -> (vals, idx) [F, nb * kb]."""
    nf, n = seeds.shape
    b = _span(n)
    kb = min(k, b)
    npad = round_up(max(n, 1), b)
    nb = npad // b
    s = pad_tail(seeds.to(torch.float32), npad, float("inf"))
    vals, pos = torch.sort(s.reshape(nf, nb, b), dim=-1, stable=True)
    vals, pos = vals[..., :kb], pos[..., :kb].to(torch.int32)
    base = (torch.arange(nb, dtype=torch.int32, device=seeds.device)
            * b)[None, :, None]
    idx = torch.where(torch.isfinite(vals), base + pos,
                      torch.full_like(pos, -1))
    return vals.reshape(nf, nb * kb), idx.reshape(nf, nb * kb)


def block_candidates(seeds: torch.Tensor, k: int):
    """seeds [F, n] -> (vals f32, idx i32) [F, nb * kb], kb = min(k, b):
    each span's kb smallest, ascending. CPU -> plain version; CUDA -> the
    kernel (counted in ``batched_block_bottomk.launches``)."""
    if seeds.device.type == "cpu":
        return block_candidates_plain(seeds, k)
    nf, n = seeds.shape
    b = _span(n)
    kb = min(k, b)
    nb = -(-max(n, 1) // b)
    if on_meta(seeds):
        return meta_call("blockselect", (seeds,), (
            torch.empty((nf, nb * kb), dtype=torch.float32, device="meta"),
            torch.empty((nf, nb * kb), dtype=torch.int32, device="meta")))
    check_cuda("seeds", seeds, torch.float32)
    vals = torch.empty((nf, nb * kb), dtype=torch.float32,
                       device=seeds.device)
    idx = torch.empty((nf, nb * kb), dtype=torch.int32, device=seeds.device)
    if n == 0:
        return vals.fill_(float("inf")), idx.fill_(-1)
    code = kernel_lib().repro_blockselect(
        seeds.data_ptr(), vals.data_ptr(), idx.data_ptr(), nf, n, b, kb,
        stream_ptr(seeds.device))
    batched_block_bottomk.launches += 1
    raise_on_error("blockselect", code)
    return vals, idx


def batched_block_bottomk(seeds: torch.Tensor, k: int):
    """seeds [F, n] -> (vals [F, nb*k], idx [F, nb*k]): the block-local k
    smallest of every span, in the reference's layout."""
    vals, idx = block_candidates(seeds, k)
    nf, n = seeds.shape
    b = _span(n)
    kb = min(k, b)
    if kb == k:
        return vals, idx
    nb = vals.shape[1] // kb
    pad = k - kb
    vals = torch.nn.functional.pad(vals.reshape(nf, nb, kb), (0, pad),
                                   value=float("inf"))
    idx = torch.nn.functional.pad(idx.reshape(nf, nb, kb), (0, pad),
                                  value=-1)
    return vals.reshape(nf, nb * k), idx.reshape(nf, nb * k)


batched_block_bottomk.launches = 0


def select_from_candidates(vals: torch.Tensor, idx: torch.Tensor, n: int,
                           k: int):
    """Second stage: one stable sort over the block candidates of an [F, n]
    input -> (vals [F, m] ascending, idx [F, m], tau [F]), m = min(k, the
    reference's candidate width). Shared by the kernel and plain paths."""
    nf = vals.shape[0]
    ksel = min(k + 1, n)
    nb = -(-max(n, 1) // _span(n))
    m = min(k + 1, nb * ksel)            # the reference's candidate width
    sv, pos = torch.sort(vals, dim=1, stable=True)
    take = min(m, sv.shape[1])
    cand_vals = sv[:, :take]
    cand_idx = torch.gather(idx, 1, pos[:, :take])
    if take < m:
        cand_vals = pad_tail(cand_vals, m, float("inf"))
        cand_idx = pad_tail(cand_idx, m, -1)
    tau = (cand_vals[:, k] if m > k
           else torch.full((nf,), float("inf"), dtype=torch.float32,
                           device=vals.device))
    return cand_vals[:, :k], cand_idx[:, :k], tau


class SelectPlan(NamedTuple):
    q: int          # candidates per row: the k + 1 smallest (all, if fewer)
    m: int          # the reference's candidate width (pads past q)
    width: int      # columns of vals and idx: min(k, m)
    blocks: int     # blocks per row
    chunk: int      # seeds per block: SELECT_WARPS segments of 32 * j
    ranked: bool    # the kernel sorts the candidates (q <= RANK_Q_MAX);
                    # else torch.sort does
    scratch: int    # zeroed words: SELECT_BINS bins and a ticket per row


def select_plan(nf: int, n: int, k: int) -> SelectPlan:
    """The global route's launch plan for seeds [nf, n] and k: grids and
    buffer sizes from (nf, n, k) alone, never from the seeds."""
    q = min(k + 1, n)
    nb = -(-max(n, 1) // _span(n))
    m = min(k + 1, nb * q)
    blocks = max(1, min(-(-n // MIN_CHUNK), -(-TARGET_BLOCKS // nf)))
    chunk = round_up(-(-max(n, 1) // blocks), SELECT_THREADS)
    return SelectPlan(q=q, m=m, width=min(k, m),
                      blocks=-(-max(n, 1) // chunk), chunk=chunk,
                      ranked=q <= RANK_Q_MAX, scratch=nf * (SELECT_BINS + 1))


def global_select(seeds: torch.Tensor, k: int):
    """``batched_bottomk_select`` of CUDA seeds [F, n] through the global
    route: the kernels find each row's q = min(k + 1, n) smallest seeds
    (ties lowest index first) and, for q <= RANK_Q_MAX, sort them into
    (vals, idx, tau) themselves; past that ``select_from_candidates``
    sorts their candidates. Counted in ``batched_block_bottomk.launches``."""
    nf, n = seeds.shape
    check_cuda("seeds", seeds, torch.float32)
    plan = select_plan(nf, n, k)
    dev = seeds.device
    f32, i32 = torch.float32, torch.int32
    cand_vals = torch.empty((nf, plan.q), dtype=f32, device=dev)
    cand_idx = torch.empty((nf, plan.q), dtype=i32, device=dev)
    if plan.q < 1:
        return select_from_candidates(cand_vals, cand_idx, n, k)
    width = plan.width if plan.ranked else 0
    vals = torch.empty((nf, width), dtype=f32, device=dev)
    idx = torch.empty((nf, width), dtype=i32, device=dev)
    tau = torch.empty((nf,), dtype=f32, device=dev)
    # held in names until the launch: a temporary's memory could go to the
    # next allocation while the kernels still use it
    state = torch.empty((nf, 4), dtype=i32, device=dev)
    counts = torch.empty((nf, plan.blocks, 2 + 2 * SELECT_WARPS), dtype=i32,
                         device=dev)
    code = kernel_lib().repro_select(
        seeds.data_ptr(), cand_vals.data_ptr(), cand_idx.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), tau.data_ptr(), state.data_ptr(),
        counts.data_ptr(), tile_tickets(dev, plan.scratch).data_ptr(), nf, n,
        plan.q, plan.m, k, plan.blocks, plan.chunk, int(plan.ranked),
        stream_ptr(dev))
    batched_block_bottomk.launches += 1
    raise_on_error("select", code)
    if plan.ranked:
        return vals, idx, tau
    return select_from_candidates(cand_vals, cand_idx, n, k)


def batched_bottomk_select(seeds: torch.Tensor, k: int):
    """Exact global bottom-k per objective row.

    seeds [F, n] -> (vals [F, m] ascending, idx [F, m]; invalid slots =
    (+inf, -1)) and tau [F] = the (k+1)-th smallest seed per row (+inf if
    fewer). Like the reference, fewer than k columns come back when
    n <= k. CPU -> the plain version; CUDA -> the global route; meta ->
    the outputs' shapes, the kernel's bytes booked (``_util.meta_call``).
    """
    if seeds.device.type == "cpu":
        return batched_bottomk_select_plain(seeds, k)
    if on_meta(seeds):
        nf, n = seeds.shape
        nb = -(-max(n, 1) // _span(n))
        width = min(k, nb * min(k + 1, n))   # as select_from_candidates
        return meta_call("blockselect", (seeds,), (
            torch.empty((nf, width), dtype=torch.float32, device="meta"),
            torch.empty((nf, width), dtype=torch.int32, device="meta"),
            torch.empty((nf,), dtype=torch.float32, device="meta")))
    return global_select(seeds, k)


def batched_bottomk_select_plain(seeds: torch.Tensor, k: int):
    """``batched_bottomk_select`` through the plain version of K2."""
    n = seeds.shape[1]
    return select_from_candidates(
        *block_candidates_plain(seeds, min(k + 1, n)), n, k)


def block_bottomk(seeds: torch.Tensor, k: int):
    """seeds [n] -> (vals [nb*k], idx [nb*k]) block-local k smallest."""
    vals, idx = batched_block_bottomk(seeds[None, :], k)
    return vals[0], idx[0]


def bottomk_select(seeds: torch.Tensor, k: int):
    """1-D exact bottom-k: (vals [k], idx [k], tau)."""
    vals, idx, tau = batched_bottomk_select(seeds[None, :], k)
    return vals[0], idx[0], tau[0]
