"""Oracles for the kernels of this package (test targets).

Port of ``repro/kernels/ref.py``. Where a kernel's plain version already
computes the oracle's function, the oracle is that plain version;
``rank_counts_ref`` stays an O(n^2) oracle for tests only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.blockselect import batched_bottomk_select_plain
from repro_torch.kernels.seeds import fused_seeds_fvals_plain
from repro_torch.kernels.segquery import segment_query_slab_plain
from repro_torch.kernels.servicecost import service_cost_slab_plain

fused_seeds_fvals_ref = fused_seeds_fvals_plain
batched_bottomk_select_ref = batched_bottomk_select_plain
segment_query_ref = segment_query_slab_plain
service_cost_ref = service_cost_slab_plain


def fused_seeds_ref(keys, weights, active, objectives, scheme="ppswor",
                    seed=0):
    """Oracle for kernels.seeds.fused_seeds."""
    return fused_seeds_fvals_plain(keys, weights, active, objectives, scheme,
                                   seed)[0]


def rank_counts_ref(weights, s_h, s_l, active):
    """Oracle for kernels.rankcount.rank_counts. O(n^2) memory."""
    w = weights.to(torch.float32)
    sh = s_h.to(torch.float32)
    sl = s_l.to(torch.float32)
    act = active.to(torch.bool)
    both = act[None, :] & act[:, None]
    pair_h = both & (sh[None, :] < sh[:, None])
    pair_l = both & (sl[None, :] < sl[:, None])
    h = (pair_h & (w[None, :] >= w[:, None])).sum(1)
    l = (pair_l & (w[None, :] < w[:, None])).sum(1)
    return h.to(torch.int32), l.to(torch.int32)


def block_bottomk_ref(seeds, k: int, block: int):
    """Oracle for kernels.blockselect.block_bottomk: each block's k
    smallest, ascending, ties lowest index first; (+inf, -1) past the
    finite ones."""
    nb = seeds.shape[0] // block
    s = seeds.to(torch.float32).reshape(nb, block)
    vals, pos = torch.sort(s, dim=1, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    idx = pos + (torch.arange(nb, device=s.device) * block)[:, None]
    idx = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
    return vals.reshape(-1), idx.reshape(-1).to(torch.int32)


def bottomk_select_ref(seeds, k: int):
    """Oracle for kernels.blockselect.bottomk_select (exact global)."""
    vals, idx, tau = batched_bottomk_select_plain(seeds[None, :], k)
    return vals[0], idx[0], tau[0]
