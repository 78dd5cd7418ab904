"""Poisson probability-proportional-to-size (pps) sampling (paper §2.1).

Port of ``repro/core/pps.py``. A data set is (keys, weights, active)
where ``active`` masks live entries (inactive slots behave as w_x = 0).
Each function runs on ``device``, else on the device of a tensor
``keys`` (``weights`` for ``pps_probabilities``), else (host arrays) on
the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import as_1d, device_of, keyed_inputs
from .funcs import StatFn
from .hashing import uniform01


class PpsSample(NamedTuple):
    """pps sample: inclusion mask + per-key probs + the auxiliary total sum
    ``fsum`` the paper (§2.3) attaches so inverse-probability weights can be
    recomputed downstream."""

    member: torch.Tensor  # bool [n] — x in S
    prob: torch.Tensor    # float32 [n] — p_x (0 for inactive keys)
    fsum: torch.Tensor    # float32 [] — sum_x f(w_x)


def pps_probabilities(weights, active, f: StatFn, k: int, device=None):
    """p_x = min(1, k f(w_x) / sum_y f(w_y))   (paper Eq. 1)."""
    dev = device_of(weights, device)
    fv = f(as_1d(weights, torch.float32, dev))
    act = as_1d(active, torch.bool, dev)
    zero = torch.zeros_like(fv)
    fv = torch.where(act, fv, zero)
    fsum = fv.sum()
    p = torch.clamp_max(k * fv / torch.clamp_min(fsum, 1e-30), 1.0)
    return torch.where(act & (fv > 0), p, zero), fsum


def pps_sample(keys, weights, active, f: StatFn, k: int, seed=0,
               device=None) -> PpsSample:
    """Independent inclusion with probability p_x^(f,k), coordinated through
    the shared hash u_x: x is included iff u_x < p_x."""
    keys, w, act = keyed_inputs(keys, weights, active, device)
    p, fsum = pps_probabilities(w, act, f, k)
    u = uniform01(keys, seed)
    return PpsSample(member=u < p, prob=p, fsum=fsum)
