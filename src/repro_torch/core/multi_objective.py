"""Multi-objective samples S^(F) (paper §3).

Port of ``repro/core/multi_objective.py``:
PPS (§3.1):      p_x^(F) = max_{(f,k_f) in F} p_x^(f,k_f)            (Eq. 4)
Bottom-k (§3.2): S^(F) = U_f S^(f,k_f) under SHARED u_x, with the
auxiliary key set Z retained so p_x^(F) is computable from the sample.

Both samplers run on ``device``, else on the device of a tensor ``keys``,
else (host arrays) on the card. Selections use a stable ascending sort, the
lowest-index-first tie order of ``lax.top_k`` (``torch.topk`` differs).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch import keyed_inputs
from .bottomk import conditional_prob, f_seed
from .funcs import StatFn
from .hashing import uniform01
from .pps import pps_probabilities

_INF = float("inf")


class MultiPps(NamedTuple):
    member: torch.Tensor  # bool [n]
    prob: torch.Tensor    # float32 [n] — p_x^(F)
    fsums: torch.Tensor   # float32 [|F|] — auxiliary per-objective totals


def multi_pps_sample(keys, weights, active,
                     objectives: Sequence[Tuple[StatFn, int]], seed=0,
                     device=None) -> MultiPps:
    """Multi-objective pps sample (Eq. 4), coordinated via shared u_x."""
    keys, w, act = keyed_inputs(keys, weights, active, device)
    probs, fsums = zip(*(pps_probabilities(w, act, f, kf)
                         for f, kf in objectives))
    p_F = torch.stack(probs).amax(dim=0)
    return MultiPps(member=uniform01(keys, seed) < p_F, prob=p_F,
                    fsums=torch.stack(fsums))


class MultiBottomK(NamedTuple):
    member: torch.Tensor  # bool [n] — x in S^(F) = union of dedicated samples
    prob: torch.Tensor    # float32 [n] — p_x^(F) = max_f p_x^(f) for members
    aux: torch.Tensor     # bool [n] — x in Z (auxiliary; carries (u_x, w_x))
    taus: torch.Tensor    # float32 [|F|] — tau^(f,k_f) per objective


def multi_bottomk_sample(keys, weights, active,
                         objectives: Sequence[Tuple[StatFn, int]],
                         scheme: str = "ppswor", seed=0,
                         device=None) -> MultiBottomK:
    """Multi-objective bottom-k sample S^(F) with aux keys Z (paper §3.2).

    All per-objective samples share u_x. For each (f, k_f): member_f(x) iff
    x's f-seed is among the k_f smallest, tau_f = the (k_f+1)-th smallest.
    Z holds, for each member x with p_x^(F) < 1, the threshold key of its
    most forgiving objective g_x, when that key is not itself a member.
    """
    keys, w, act = keyed_inputs(keys, weights, active, device)
    u = uniform01(keys, seed)
    n = w.shape[0]
    nf = len(objectives)

    seeds_F = torch.stack([f_seed(w, act, f, u, scheme)
                           for f, _ in objectives])
    fv_F = torch.stack([torch.where(act, f(w), torch.zeros_like(w))
                        for f, _ in objectives])
    kks = [min(kf, n) for _, kf in objectives]
    sorted_vals = torch.sort(seeds_F, dim=1, stable=True).values
    sorted_vals = sorted_vals[:, :min(max(kks) + 1, n)]
    kth = torch.stack([sorted_vals[j, kk - 1] for j, kk in enumerate(kks)])
    inf = torch.tensor(_INF, device=w.device)
    taus = torch.stack([sorted_vals[j, kk] if n > kk else inf
                        for j, kk in enumerate(kks)])

    members_F = ((seeds_F < kth[:, None])
                 | ((seeds_F == kth[:, None]) & torch.isfinite(seeds_F)))
    probs = torch.where(members_F,
                        conditional_prob(fv_F, taus[:, None], scheme),
                        torch.zeros_like(fv_F))
    # threshold key of objective f: the key whose seed == tau_f
    thr_key_onehots = (torch.isfinite(taus)[:, None]
                       & (seeds_F == taus[:, None]))

    member = members_F.any(dim=0)
    p_F = probs.amax(dim=0)
    # g_x = argmax_f p_x^(f): p_f is 0 for non-members of f, so the plain
    # argmax (first maximum, as jnp.argmax) is the paper's g_x
    g_x = probs.argmax(dim=0)
    member_needs = member & (p_F < 1.0)
    needed_f = (member_needs[None, :]
                & (g_x[None, :] == torch.arange(nf, device=w.device)[:, None])
                ).any(dim=1)
    aux = (thr_key_onehots & needed_f[:, None]).any(dim=0) & ~member
    return MultiBottomK(member=member,
                        prob=torch.where(member, p_F, torch.zeros_like(p_F)),
                        aux=aux, taus=taus)
