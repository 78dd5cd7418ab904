"""K2: block-local bottom-k selection over [F, n] seed rows, one launch.

Port of ``repro/kernels/blockselect.py``. Two-level exact selection:
  1. the kernel (``csrc/blockselect.cu``): per objective row and span of
     b <= 2048 slots, the k smallest seeds ascending, ties lowest index
     first, invalid = (+inf, -1);
  2. one stable sort over the [F, nb * kb] candidates. Candidates are
     block-major and index-ascending within a block, so the stable sort
     gives the global lowest-index-first tie order of ``lax.top_k``.

A span holds at most b entries, so the kernel writes kb = min(k, b)
candidates per block; ``batched_block_bottomk`` pads them back to the
reference's [F, nb * k] layout with (+inf, -1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._util import (check_cuda, kernel_lib, pad_tail,
                                       raise_on_error, round_up, stream_ptr)

BLOCK = 2048


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
    check_cuda("seeds", seeds, torch.float32)
    b = _span(n)
    kb = min(k, b)
    nb = -(-max(n, 1) // b)
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


def batched_bottomk_select(seeds: torch.Tensor, k: int):
    """Exact global bottom-k per objective row.

    seeds [F, n] -> (vals [F, m] ascending, idx [F, m]; invalid slots =
    (+inf, -1)) and tau [F] = the (k+1)-th smallest seed per row (+inf if
    fewer). Like the reference, fewer than k columns come back when
    n <= k.
    """
    n = seeds.shape[1]
    return select_from_candidates(*block_candidates(seeds, min(k + 1, n)),
                                  n, k)


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
