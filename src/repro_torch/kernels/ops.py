"""Entry points composing the kernels into the paper's sampling operations.

Port of ``repro/kernels/ops.py``. The multi-objective path is one launch of
K1 (seeds + f-values for all |F| objectives), one call of K2 (the global
bottom-k select of every row, its candidates sorted in the kernel), then
vectorized [F, n] membership and probabilities: no loop over objectives.
Universal capping membership is one call of K6 (two orderings, then the
dominance count). Both run on ``device``, else on the device of a tensor
``keys``, else (host arrays) on the card; CPU tensors take the kernels'
plain versions.
"""
from __future__ import annotations

import torch

from repro_torch import keyed_inputs
from repro_torch.core.bottomk import conditional_prob
from repro_torch.core.funcs import StatFn
from repro_torch.core.hashing import rank_of, uniform01
from repro_torch.kernels.blockselect import batched_bottomk_select
from repro_torch.kernels.rankcount import rank_counts
from repro_torch.kernels.seeds import fused_seeds_fvals

# the seeds kernel's objective encoding (kernels/seeds.py)
_KIND_NAMES = {0: "sum", 1: "count", 2: "thresh", 3: "cap", 4: "moment"}


def statfn_of(kind: int, param: float) -> StatFn:
    """The core StatFn equivalent of a (kind, param) kernel objective."""
    return StatFn(_KIND_NAMES[kind], float(param))


def multi_objective_bottomk_kernel(keys, weights, active, objectives,
                                   k: int, scheme="ppswor", seed=0,
                                   device=None):
    """Multi-objective bottom-k sample S^(F) through K1 and K2.

    Returns (member [n] bool, prob [n] float32), the member/prob of
    ``core.multi_objective.multi_bottomk_sample`` with k_f = k for every
    (kind, param) objective.
    """
    keys, w, act = keyed_inputs(keys, weights, active, device)
    kk = min(k, keys.shape[0])
    seeds, fvals = fused_seeds_fvals(keys, w, act, objectives, scheme, seed)
    vals, _idx, tau = batched_bottomk_select(seeds, kk)
    kth = vals[:, kk - 1]                                  # [F]
    member_f = (seeds <= kth[:, None]) & torch.isfinite(seeds)
    p_f = torch.where(member_f,
                      conditional_prob(fvals, tau[:, None], scheme),
                      torch.zeros_like(fvals))
    return member_f.any(dim=0), p_f.amax(dim=0)


def universal_capping_kernel(keys, weights, active, k: int, scheme="ppswor",
                             seed=0, device=None):
    """S^(C,k) membership through K6 (Lemma 6.3): h + l < k.

    Returns (member, hl = min(h + l, k + 1)); hl is defined on active keys
    only (0 + 0 elsewhere). The probabilities are the candidate pass of
    ``core.capping``, which this entry point does not run.
    """
    keys, w, act = keyed_inputs(keys, weights, active, device)
    act = act & (w > 0)
    u = uniform01(keys, seed)
    r = rank_of(u, scheme)
    inf = torch.full_like(w, float("inf"))
    rw = torch.where(act, r / torch.clamp_min(w, 1e-30), inf)
    # h uses u as the order statistic; l uses r/w
    h, l = rank_counts(torch.where(act, w, torch.zeros_like(w)), u, rw, act)
    hl = h + l
    return act & (hl < k), torch.clamp_max(hl, k + 1)
