"""Inverse-probability (Horvitz-Thompson) estimators for segment
f-statistics: Q^(g, H) = sum_{x in S ∩ H} g(w_x) / p_x.

Port of ``repro/core/estimators.py`` (``estimate_many``, ``cv_bound``).
"""
from __future__ import annotations

import math

import torch


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


def cv_bound(q_rel: float, k: int, rho: float = 1.0) -> float:
    """Paper CV upper bound sqrt(rho / (q * (k-1))) (bottom-k variant)."""
    return float(math.sqrt(rho / (max(q_rel, 1e-30) * max(k - 1, 1))))
