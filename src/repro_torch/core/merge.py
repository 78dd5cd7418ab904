"""Mergeable fixed-capacity sketches of the universal monotone sample
(paper §2.5, §3.3, §5.2).

Port of ``repro/core/merge.py`` (``Sketch``; the contracts of the
multi-objective ``MultiSketch`` live in ``multi_sketch.py``). A ``Sketch``
is a fixed-capacity array of (key, weight, prob) slots covering S ∪ Z plus
validity bits. Merging is a concat + dedup (max weight) + re-selection, and
is EXACT: S ∪ Z of a union lies in the union of the parts' S ∪ Z, so the
merged sketch is the one the union data set would have produced. u_x comes
from the shared hash, so a key carries the same u on every shard.

``build_sketch`` runs on ``device``, else on the device of a tensor
``keys``, else (host arrays) on the card; merges follow their inputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import keyed_inputs, lexsort
from .universal import UniversalSample, universal_monotone_sample


class Sketch(NamedTuple):
    keys: torch.Tensor     # int32 [c] — key ids (-1 for empty slots)
    weights: torch.Tensor  # float32 [c]
    probs: torch.Tensor    # float32 [c] — p(w) for members (0 otherwise)
    member: torch.Tensor   # bool [c] — in S (vs auxiliary-only in Z)
    valid: torch.Tensor    # bool [c]
    k: int                 # sample-size parameter
    seed: int              # hash seed (must match to merge)


def sketch_capacity(n_hint: int, k: int) -> int:
    """Suggested capacity ~ 2 k ln n (Thm 5.1 bound + slack for Z)."""
    return int(2 * k * max(2.0, math.log(max(n_hint, 4))) + 2 * k)


def build_sketch(keys, weights, active, k: int, capacity: int,
                 seed: int = 0, device=None) -> Sketch:
    """Compute S^(M,k) over a batch and compact S ∪ Z into a Sketch."""
    keys, weights, active = keyed_inputs(keys, weights, active, device)
    s = universal_monotone_sample(keys, weights, active, k, seed=seed)
    return _compact(keys, weights, s, k, capacity, seed)


def _compact(keys, weights, s: UniversalSample, k: int, capacity: int,
             seed: int) -> Sketch:
    keep = s.member | s.aux
    # kept first, members before aux, then by weight descending (the
    # reference's lexsort((-w, ~member, ~keep)); booleans sort as integers)
    order = lexsort((-weights, (~s.member).to(torch.uint8),
                      (~keep).to(torch.uint8)))
    n = order.shape[0]
    if n < capacity:  # pad so every sketch carries exactly `capacity` slots
        order = torch.cat([order, torch.zeros(capacity - n,
                                              dtype=order.dtype,
                                              device=order.device)])
        pad_valid = torch.arange(capacity, device=order.device) < n
    else:
        order = order[:capacity]
        pad_valid = torch.ones((capacity,), dtype=torch.bool,
                               device=order.device)
    keep_t = keep[order] & pad_valid
    w_t = weights[order]
    p_t = s.prob[order]
    return Sketch(
        keys=torch.where(keep_t, keys[order], torch.full_like(keys[order],
                                                              -1)),
        weights=torch.where(keep_t, w_t, torch.zeros_like(w_t)),
        probs=torch.where(keep_t, p_t, torch.zeros_like(p_t)),
        member=s.member[order] & keep_t,
        valid=keep_t,
        k=k, seed=seed)


def _rebuild(keys, weights, valid, k: int, capacity: int,
             seed: int) -> Sketch:
    # dedup by key keeping max weight (paper: w_x = max over elements)
    order = lexsort((-weights, keys))
    sk, sw, sv = keys[order], weights[order], valid[order]
    dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=sk.device),
                     sk[1:] == sk[:-1]])
    act = sv & ~dup & (sk >= 0)
    s = universal_monotone_sample(sk, sw, act, k, seed=seed)
    return _compact(sk, sw, s, k, capacity, seed)


def merge_sketches(a: Sketch, b: Sketch, donate: bool = False) -> Sketch:
    """Merge two sketches (same k/seed): concat, dedup (keep max weight),
    re-select. Exact per paper §5.2.

    ``donate=True`` writes the result into ``a``'s slab tensors, so a
    streaming fold (state <- merge(state, new)) keeps one slab; the inputs
    must not be used afterwards. The result is identical either way.
    """
    assert a.k == b.k and a.seed == b.seed, \
        "sketches must share k and hash seed"
    m = _rebuild(torch.cat([a.keys, b.keys]),
                 torch.cat([a.weights, b.weights]),
                 torch.cat([a.valid, b.valid]), a.k, a.keys.shape[0],
                 a.seed)
    if not donate:
        return m
    for dst, src in zip(a[:5], m[:5]):
        dst.copy_(src)
    return a


def merge_many(sketches_keys, sketches_weights, sketches_valid, k: int,
               capacity: int, seed: int) -> Sketch:
    """Merge a stacked batch of sketches [m, c] -> one sketch (one
    re-selection over all of them)."""
    return _rebuild(sketches_keys.reshape(-1), sketches_weights.reshape(-1),
                    sketches_valid.reshape(-1), k, capacity, seed)


def sketch_estimate(sk, f, segment_fn=None) -> torch.Tensor:
    """HT estimate of Q(f, H) from a sketch (``Sketch`` or ``MultiSketch`` —
    any record with member/weights/probs/keys fields).

    segment_fn: optional vectorized predicate over keys selecting the
    segment H (default: the whole data set).
    """
    member = sk.member
    if segment_fn is not None:
        member = member & torch.as_tensor(segment_fn(sk.keys),
                                          device=member.device).to(
                                              torch.bool)
    fv = f(sk.weights)
    return torch.where(member, fv / torch.clamp_min(sk.probs, 1e-30),
                       torch.zeros_like(fv)).sum()
