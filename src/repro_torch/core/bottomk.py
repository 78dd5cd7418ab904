"""Bottom-k (order) sampling primitives: priority and ppswor.

Port of ``repro/core/bottomk.py``: f-seed(x) = r_x / f(w_x), the k-th and
(k+1)-th smallest seeds, the bottom-k sample w.r.t. one f, and the
conditional inclusion probabilities
    priority: p_x = min(1, f(w_x) * tau)
    ppswor:   p_x = 1 - exp(-f(w_x) * tau)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import keyed_inputs
from .funcs import StatFn
from .hashing import rank_of, uniform01


def f_seed(weights, active, f: StatFn, u, scheme: str) -> torch.Tensor:
    """f-seed(x) = r_x / f(w_x); inactive or f(w) = 0 keys get +inf."""
    r = rank_of(u, scheme)
    fv = f(weights)
    ok = active & (fv > 0)
    return torch.where(ok, r / torch.clamp_min(fv, 1e-30),
                       torch.full_like(fv, float("inf")))


def kth_and_tau(x: torch.Tensor, k: int):
    """(k-th, (k+1)-th) smallest of x along the last axis; tau = +inf when
    there is no (k+1)-th entry."""
    n = x.shape[-1]
    kk = min(k, n)
    vals = torch.sort(x, dim=-1, stable=True).values[..., :kk + 1]
    kth = vals[..., kk - 1]
    tau = (vals[..., kk] if n > kk
           else torch.full(x.shape[:-1], float("inf"), dtype=torch.float32,
                           device=x.device))
    return kth, tau


def conditional_prob(fv, tau, scheme: str) -> torch.Tensor:
    """Eq. (3): Pr_{u~U[0,1]}[r/f(w) < tau]."""
    t = torch.clamp_min(fv, 0.0) * tau
    if scheme == "priority":
        return torch.clamp_max(t, 1.0)
    # ppswor; tau may be +inf (fewer than k+1 active keys) -> p = 1
    return torch.where(torch.isinf(t), torch.ones_like(t), -torch.expm1(-t))


class BottomK(NamedTuple):
    member: torch.Tensor   # bool [n] — x in S (the k smallest f-seeds)
    prob: torch.Tensor     # float32 [n] — conditional p_x for members, else 0
    tau: torch.Tensor      # float32 [] — (k+1)-th smallest f-seed
    seeds: torch.Tensor    # float32 [n] — the f-seeds (inf for inactive)


def bottomk_sample(keys, weights, active, f: StatFn, k: int,
                   scheme: str = "ppswor", seed=0, device=None) -> BottomK:
    """Bottom-k sample w.r.t. f, with conditional inclusion probabilities.

    For member x the k-th smallest f-seed among OTHER keys equals tau (the
    global (k+1)-th smallest), the conditioning of the paper (§2.3). Runs
    on ``device``, else on the device of a tensor ``keys``, else (host
    arrays) on the card.
    """
    keys, w, act = keyed_inputs(keys, weights, active, device)
    u = uniform01(keys, seed)
    seeds = f_seed(w, act, f, u, scheme)
    kth, tau = kth_and_tau(seeds, k)
    member = (seeds < kth) | ((seeds == kth) & torch.isfinite(seeds))
    fv = f(w)
    fv = torch.where(act, fv, torch.zeros_like(fv))
    p = torch.where(member, conditional_prob(fv, tau, scheme),
                    torch.zeros_like(fv))
    return BottomK(member=member, prob=p, tau=tau, seeds=seeds)
