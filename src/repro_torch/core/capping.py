"""Universal capping sample S^(C,k), C = {cap_T : T > 0} (paper §6).

Port of ``repro/core/capping.py``. Membership (Lemma 6.3):
x in S^(C,k) <=> h_x + l_x < k, where
    h_x = #{y : w_y >= w_x and u_y < u_x}                (same h as §5)
    l_x = #{y : w_y <  w_x and r_y / w_y < r_x / w_x}
Estimation (Cor. 6.2 + Eq. 3): p_x = Pr[r_x / w_x < t_x], t_x the k-th
smallest cap_{w_x}-seed r_y / min(w_y, w_x) over y != x; the k+1 smallest
of those belong to keys with h_y + l_y <= k, so the final pass runs over
that candidate set only (the paper's §6.1 algorithm).

Size (Thm 6.1): E|S^(C,k)| <= e k ln(w_max/w_min).

``universal_capping_sample`` = two sorted rank scans (h by (-w, u), l by
(w, r/w)) + an O(m^2) pass over at most m_cap candidates. The samplers run
on ``device``, else on the device of a tensor ``keys`` (``weights`` for the
oracle), else (host arrays) on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import as_1d, device_of, keyed_inputs, lexsort
from .bottomk import conditional_prob
from .hashing import rank_of, uniform01
from .universal import _INF, _scan_ranks, _unsort


class CappingSample(NamedTuple):
    member: torch.Tensor  # bool [n]
    prob: torch.Tensor    # float32 [n] — p_x^(C,k) for members else 0
    aux: torch.Tensor     # bool [n] — potential/actual aux keys (h+l == k)
    hl: torch.Tensor      # int32 [n] — h_x + l_x capped at k+1


def _pairwise_capping(w, r, act, k: int) -> torch.Tensor:
    """t_x = k-th smallest cap_{w_x}-seed over y != x. O(n^2). w,r: [n]."""
    n = w.shape[0]
    if n < k:
        return torch.full((n,), _INF, device=w.device)
    capw = torch.minimum(w[None, :], w[:, None])          # cap_{w_x}(w_y)
    seeds = torch.where(act[None, :] & (capw > 0),
                        r[None, :] / torch.clamp_min(capw, 1e-30),
                        torch.full_like(capw, _INF))
    seeds.fill_diagonal_(_INF)                            # exclude y == x
    return torch.kthvalue(seeds, k, dim=1).values


def universal_capping_ref(weights, u, active, k: int, scheme: str = "ppswor",
                          device=None) -> CappingSample:
    """Exact O(n^2) oracle."""
    dev = device_of(weights, device)
    w = as_1d(weights, torch.float32, dev)
    u = as_1d(u, torch.float32, dev)
    act = as_1d(active, torch.bool, dev) & (w > 0)
    r = rank_of(u, scheme)
    rw = torch.where(act, r / torch.clamp_min(w, 1e-30),
                     torch.full_like(w, _INF))

    h = (act[None, :] & (w[None, :] >= w[:, None])
         & (u[None, :] < u[:, None])).sum(1)
    l = (act[None, :] & (w[None, :] < w[:, None])
         & (rw[None, :] < rw[:, None])).sum(1)
    hl = (h + l).to(torch.int32)
    member = act & (hl < k)

    t = _pairwise_capping(w, r, act, k)
    p = torch.where(member, conditional_prob(w, t, scheme),
                    torch.zeros_like(w))
    return CappingSample(member=member, prob=p, aux=act & (hl == k),
                         hl=torch.clamp_max(hl, k + 1))


def universal_capping_sample(keys, weights, active, k: int, m_cap: int,
                             scheme: str = "ppswor", seed=0, u=None,
                             device=None) -> CappingSample:
    """Production S^(C,k): two rank scans + O(m_cap^2) candidate pass.

    m_cap: capacity for the candidate set {h + l <= k}; raise it to about
    e k ln(w_max/w_min) + slack. Candidates past m_cap are dropped from the
    pairwise pass: membership stays exact (it comes from the scans), only
    the probs of dropped members would be wrong.
    """
    keys, w, act = keyed_inputs(keys, weights, active, device)
    act = act & (w > 0)
    dev = w.device
    u = (uniform01(keys, seed) if u is None
         else as_1d(u, torch.float32, dev))
    r = rank_of(u, scheme)
    n = w.shape[0]
    pos = torch.arange(n, device=dev)
    inf = torch.full_like(w, _INF)

    # --- h-scan: process by decreasing w (ties: increasing u) ---------------
    order_h = lexsort((u, -torch.where(act, w, -inf)))
    rank_h = _scan_ranks(torch.where(act[order_h], u[order_h], inf), k + 1)
    h = _unsort(order_h, torch.clamp_max(rank_h, k + 1))

    # --- l-scan: process by increasing w (ties: increasing r/w) -------------
    rw = torch.where(act, r / torch.clamp_min(w, 1e-30), inf)
    order_l = lexsort((rw, torch.where(act, w, inf)))
    sw = torch.where(act, w, inf)[order_l]
    rank_l = _scan_ranks(torch.where(act[order_l], rw[order_l], inf), k + 1)
    # subtract the position within the weight group: earlier keys of the
    # same weight have smaller r/w and were counted, but are not w_y < w_x.
    # The group start is a left-side searchsorted of the ascending weights
    # (the reference's running max of group starts, as ``cummax``, would
    # be one single-row scan over all n on the card).
    gpos = pos - torch.searchsorted(sw, sw)
    sat = rank_l >= k + 1        # saturated => h + l > k regardless
    l_sorted = torch.where(sat, torch.full_like(rank_l, k + 1),
                           torch.clamp_min(rank_l - gpos, 0).to(torch.int32))
    l = _unsort(order_l, l_sorted)

    hl = torch.clamp_max(h + l, k + 1)
    member = act & (hl < k)
    aux = act & (hl == k)

    # --- candidate pass: exact t_x over the {h+l <= k} set ------------------
    cand_idx = torch.where(act & (hl <= k), pos, torch.full_like(pos, n))
    cand_idx = torch.sort(cand_idx).values[:m_cap]   # first m_cap candidates
    valid = cand_idx < n
    ci = torch.where(valid, cand_idx, torch.zeros_like(cand_idx))
    cw, cr = w[ci], r[ci]
    t_c = _pairwise_capping(cw, cr, valid & act[ci], k)
    p_c = conditional_prob(cw, t_c, scheme)
    prob = torch.zeros((n + 1,), dtype=torch.float32, device=dev)
    prob[torch.where(valid, ci, torch.full_like(ci, n))] = p_c
    prob = torch.where(member, prob[:n], torch.zeros_like(w))
    return CappingSample(member=member, prob=prob, aux=aux, hl=hl)


def capping_size_bound(k: int, w_max: float, w_min: float) -> float:
    """Thm 6.1: E|S^(C,k)| <= e k ln(w_max / w_min)."""
    return math.e * k * max(1.0, math.log(max(w_max / max(w_min, 1e-30),
                                              math.e)))
