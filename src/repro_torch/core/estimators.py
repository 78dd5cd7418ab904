"""Inverse-probability (Horvitz-Thompson) estimators for segment
f-statistics: Q^(g, H) = sum_{x in S ∩ H} g(w_x) / p_x.

Port of ``repro/core/estimators.py``. Each function runs on ``device``,
else on the device of its probs (estimates) or weights (exact values) when
that is a tensor, else (host arrays) on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch import as_1d, device_of
from .funcs import StatFn


def _ht(f: StatFn, w, probs, sel) -> torch.Tensor:
    """Per-key HT contribution f(w_x) / p_x on ``sel``, else 0."""
    fv = f(w)
    return torch.where(sel, fv / torch.clamp_min(probs, 1e-30),
                       torch.zeros_like(fv))


def _selection(mask, segment, dev) -> torch.Tensor:
    sel = as_1d(mask, torch.bool, dev)
    return sel if segment is None else sel & as_1d(segment, torch.bool, dev)


def estimate(f: StatFn, weights, probs, member, segment=None, device=None):
    """Q^(f, H). ``segment``: bool mask for H (None = whole key space)."""
    dev = device_of(probs, device)
    return _ht(f, as_1d(weights, torch.float32, dev),
               as_1d(probs, torch.float32, dev),
               _selection(member, segment, dev)).sum()


def estimate_segments(f: StatFn, weights, probs, member, segment_ids,
                      num_segments: int, device=None):
    """Q^(f, H_j) for a partition into ``num_segments`` segments at once."""
    dev = device_of(probs, device)
    contrib = _ht(f, as_1d(weights, torch.float32, dev),
                  as_1d(probs, torch.float32, dev),
                  _selection(member, None, dev))
    return _segment_sum(contrib, as_1d(segment_ids, torch.int64, dev),
                        num_segments)


def estimate_many(fs, weights, probs, member, segments) -> torch.Tensor:
    """Q^(f_i, H_b) for |F| objectives x B segments -> float32 [|F|, B].

    segments: bool [B, n]. Each answer is a reduction over its own row of
    contributions, so its bits do not depend on which other segments share
    the batch (a matrix product may block differently for another B).
    """
    probs = torch.as_tensor(probs).to(torch.float32)
    ht = torch.where(member, 1.0 / torch.clamp_min(probs, 1e-30),
                     torch.zeros_like(probs))
    contrib = torch.stack([f(weights) for f in fs]) * ht       # [F, n]
    sel = torch.as_tensor(segments).to(torch.float32)          # [B, n]
    return (contrib[:, None, :] * sel[None, :, :]).sum(-1)


def exact(f: StatFn, weights, active, segment=None, device=None):
    """Ground-truth Q(f, H) for validation."""
    dev = device_of(weights, device)
    fv = f(as_1d(weights, torch.float32, dev))
    return torch.where(_selection(active, segment, dev), fv,
                       torch.zeros_like(fv)).sum()


def exact_segments(f: StatFn, weights, active, segment_ids,
                   num_segments: int, device=None):
    dev = device_of(weights, device)
    fv = f(as_1d(weights, torch.float32, dev))
    contrib = torch.where(_selection(active, None, dev), fv,
                          torch.zeros_like(fv))
    return _segment_sum(contrib, as_1d(segment_ids, torch.int64, dev),
                        num_segments)


def _segment_sum(contrib, ids, num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum: ids outside [0, num_segments) are dropped."""
    ok = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,), dtype=torch.float32,
                      device=contrib.device)
    return out.index_add_(0, ids[ok], contrib[ok])


def cv_bound(q_rel: float, k: int, rho: float = 1.0) -> float:
    """Paper CV upper bound sqrt(rho / (q * (k-1))) (bottom-k variant)."""
    return float(math.sqrt(rho / (max(q_rel, 1e-30) * max(k - 1, 1))))
