"""Universal monotone sample S^(M,k) (paper §5).

Port of ``repro/core/universal.py``:
  Lemma 5.1/5.2:  x in S^(M,k) <=> h_x < k, h_x = #{y : w_y >= w_x, u_y < u_x}.
  Estimation:     for member x, p(w_x) = (k+1)-th smallest u among
                  {y : w_y >= w_x} (1 when fewer than k+1 such keys).
  Aux keys Z:     the keys realizing those (k+1)-th smallest values for at
                  least one member's weight group, minus S.
  Size bound:     E|S^(M,k)| <= k ln n (Thm 5.1).

``universal_monotone_ref`` is the O(n^2) pairwise oracle (tests, small n).
``universal_monotone_sample`` sorts by (-w, u) and runs ``_buffer_scan``,
the paper's Algorithm 1 with the heap replaced by a (k+1)-slot sorted
buffer. The reference runs that scan as a ``lax.scan``; here it is written
in closed form with whole-tensor operations (no per-element or per-chunk
launches) and is bit-identical to ``_buffer_scan_ref``, the one-element-
per-step oracle.

The samplers run on ``device``, else on the device of a tensor ``keys``,
else (host arrays) on the card.
"""
from __future__ import annotations

import bisect
import math
from typing import NamedTuple

import torch

from repro_torch import as_1d, device_of, keyed_inputs, lexsort
from .hashing import uniform01

_INF = float("inf")
_RANK_CHUNK = 64           # elements per chunk of the rank pass
_TAIL_BLOCK = 1 << 24      # entries of one block of the tail pass


class UniversalSample(NamedTuple):
    member: torch.Tensor  # bool [n] — x in S^(M,k)
    prob: torch.Tensor    # float32 [n] — p(w_x) for members, else 0
    aux: torch.Tensor     # bool [n] — x in Z (kept for mergeability)
    h: torch.Tensor       # int32 [n] — h_x capped at k+1


def _scatter_mark(idx, need, n: int) -> torch.Tensor:
    """bool [n], True at ``idx[need]`` (the reference's
    ``.at[where(need, idx, n)].set(True, mode="drop")``)."""
    marks = torch.zeros((n + 1,), dtype=torch.bool, device=idx.device)
    marks[torch.where(need, idx.to(torch.int64),
                      torch.full_like(idx, n, dtype=torch.int64))] = True
    return marks[:n]


def _unsort(order, values) -> torch.Tensor:
    """The inverse permutation of ``order`` applied: out[order] = values."""
    out = torch.empty_like(values)
    out[order] = values
    return out


# ---------------------------------------------------------------------------
# O(n^2) oracle
# ---------------------------------------------------------------------------

def universal_monotone_ref(weights, u, active, k: int,
                           device=None) -> UniversalSample:
    """Exact pairwise-definition implementation. O(n^2) memory/compute."""
    dev = device_of(weights, device)
    w = as_1d(weights, torch.float32, dev)
    u = as_1d(u, torch.float32, dev)
    act = as_1d(active, torch.bool, dev) & (w > 0)
    n = w.shape[0]

    ge = act[None, :] & (w[None, :] >= w[:, None])            # [x, y]
    h = (ge & (u[None, :] < u[:, None])).sum(1).to(torch.int32)
    member = act & (h < k)

    # p(w_x) = (k+1)-th smallest u among {y : w_y >= w_x} (x included)
    cand = torch.where(ge, u[None, :], torch.full_like(ge, _INF,
                                                       dtype=torch.float32))
    if n > k:
        srt, arg = torch.sort(cand, dim=1, stable=True)
        g, g_idx = srt[:, k], arg[:, k]
    else:
        g = torch.full((n,), _INF, device=dev)
        g_idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    one, zero = torch.ones_like(g), torch.zeros_like(g)
    prob = torch.where(member, torch.where(torch.isfinite(g), g, one), zero)
    aux = _scatter_mark(g_idx, member & torch.isfinite(g), n) & ~member
    return UniversalSample(member=member, prob=prob, aux=aux,
                           h=torch.clamp_max(h, k + 1))


# ---------------------------------------------------------------------------
# the (k+1)-buffer scan (Algorithm 1)
# ---------------------------------------------------------------------------

def _buffer_scan_ref(values, indices, k_plus_1: int):
    """Sequential oracle: one step per element, as the reference's
    ``lax.scan``. The buffer holds the k_plus_1 smallest values so far,
    ascending; an element is inserted at its rank = #{buffer < v} (strictly
    smaller, so a tied v lands before its equals) and the tail slot is
    evicted, also on a tie at the capacity boundary. Per step: (rank,
    tail value, tail index) after the step; the buffer starts as
    (+inf, -1)."""
    buf_v = [_INF] * k_plus_1
    buf_i = [-1] * k_plus_1
    rank, tail_v, tail_i = [], [], []
    for v, i in zip(values.to(torch.float32).tolist(), indices.tolist()):
        r = bisect.bisect_left(buf_v, v)
        if r < k_plus_1:
            buf_v.insert(r, v)
            buf_v.pop()
            buf_i.insert(r, i)
            buf_i.pop()
        rank.append(r)
        tail_v.append(buf_v[-1])
        tail_i.append(buf_i[-1])
    dev = values.device
    return (torch.tensor(rank, dtype=torch.int32, device=dev),
            torch.tensor(tail_v, dtype=torch.float32, device=dev),
            torch.tensor(tail_i, dtype=torch.int32, device=dev))


def _prefix_smallest(vp: torch.Tensor, k1: int, pad) -> torch.Tensor:
    """[nc, k1]: for each row (chunk) of ``vp`` [nc, c], the k1 smallest
    entries of all rows before it, ascending, ``pad`` where fewer. An
    inclusive scan by doubling (merging k1-smallest multisets is
    associative), then shifted by one row."""
    nc = vp.shape[0]
    small = torch.sort(vp, dim=1).values[:, :k1]
    if small.shape[1] < k1:
        small = torch.nn.functional.pad(small, (0, k1 - small.shape[1]),
                                        value=pad)
    d = 1
    while d < nc:
        merged = torch.sort(torch.cat([small[d:], small[:-d]], dim=1),
                            dim=1).values[:, :k1]
        small = torch.cat([small[:d], merged])
        d *= 2
    return torch.cat([torch.full((1, k1), pad, dtype=vp.dtype,
                                 device=vp.device), small[:-1]])


def _chunked(v: torch.Tensor, pad):
    """``v`` padded with ``pad`` to whole chunks of _RANK_CHUNK -> [nc, c]
    (the pad comes after every element)."""
    n = v.shape[0]
    c = min(_RANK_CHUNK, n)
    nc = -(-n // c)
    return torch.nn.functional.pad(v, (0, nc * c - n), value=pad).reshape(
        nc, c)


def _scan_ranks(v: torch.Tensor, k1: int) -> torch.Tensor:
    """rank_t = min(#{s < t : v_s < v_t}, k1), the buffer scan's rank, for
    every position at once.

    Chunks of _RANK_CHUNK: the count within a chunk is one masked pairwise
    comparison; the count before it is a ``searchsorted`` into the k1
    smallest values of all earlier chunks (``_prefix_smallest``).
    min(min(a, k1) + b, k1) = min(a + b, k1), so the capped sum is exact.
    """
    n = v.shape[0]
    vp = _chunked(v, _INF)
    c = vp.shape[1]
    earlier = torch.ones((c, c), dtype=torch.bool, device=v.device).tril(-1)
    within = ((vp[:, None, :] < vp[:, :, None]) & earlier).sum(
        -1, dtype=torch.int32)
    before = _prefix_smallest(vp, k1, _INF)
    cc = torch.searchsorted(before, vp)     # side='left': #{before < v}
    rank = torch.clamp_max(cc + within, k1)
    return rank.reshape(-1)[:n].to(torch.int32)


def _prefix_tails(cv: torch.Tensor, ci: torch.Tensor, k1: int):
    """Buffer tails after each step of a replay of (cv, ci).

    The buffer after step j holds the k1 first elements of steps 0..j in
    buffer order (value ascending, the later step first among equals:
    a tie inserts before its equals, so the oldest are evicted first),
    then the (+inf, -1) initial slots. With each step's position ``pos``
    in that order (one sort of the m elements), the tail at step j is the
    k1-th smallest pos of steps 0..j: the k1 smallest of the earlier
    chunks (``_prefix_smallest``) merged with the chunk's own steps up to
    j, O(m (k1 + c)) work in blocks of _TAIL_BLOCK entries.
    """
    m = cv.shape[0]
    steps = torch.arange(m, device=cv.device)
    order = steps.flip(0)                               # later step first
    order = order[torch.sort(cv[order], stable=True).indices]
    sv, si = cv[order], ci[order]
    pp = _chunked(_unsort(order, steps), m)         # m: no element
    nc, c = pp.shape
    before = _prefix_smallest(pp, k1, m)
    upto = torch.ones((c, c), dtype=torch.bool, device=cv.device).tril()
    q = torch.empty((nc, c), dtype=pp.dtype, device=cv.device)
    rows = max(1, _TAIL_BLOCK // (c * (k1 + c)))
    for b0 in range(0, nc, rows):
        blk = pp[b0:b0 + rows]
        cand = torch.cat(
            [before[b0:b0 + rows, None, :].expand(-1, c, -1),
             torch.where(upto, blk[:, None, :], m)], dim=2)
        q[b0:b0 + rows] = torch.sort(cand, dim=2).values[:, :, k1 - 1]
    q = q.reshape(-1)[:m]
    found = q < m
    q = torch.clamp_max(q, m - 1)
    tail_v = torch.where(found, sv[q], torch.full_like(sv[q], _INF))
    tail_i = torch.where(found, si[q], torch.full_like(si[q], -1))
    return tail_v, tail_i


def _buffer_scan(values, indices, k_plus_1: int):
    """Scan ``values`` (processing order) keeping the k_plus_1 smallest.

    Per position emits:
      rank   — min(#{earlier with value < v}, k_plus_1);
      tail_v — the buffer's largest kept value after the step (the
               k_plus_1-th smallest so far, inf if fewer);
      tail_i — index of the key realizing tail_v (-1 if none),
    bit-identical to ``_buffer_scan_ref``.

    The ranks come from ``_scan_ranks``. An element whose rank saturates
    is never inserted, so the tails are those of a replay of the m
    inserted elements (about k_plus_1 ln n for a hashed processing order,
    up to n for a near-descending one), forward-filled over the dropped
    positions, which never change the buffer.
    """
    n = values.shape[0]
    k1 = k_plus_1
    dev = values.device
    if n == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    v = values.to(torch.float32).contiguous()
    ix = indices.to(torch.int32)
    rank = _scan_ranks(v, k1)
    inserted = rank < k1
    fill = inserted.cumsum(0) - 1   # last inserted step (step 0 always is)
    m = int(fill[-1]) + 1
    slot = torch.where(inserted, fill, torch.full_like(fill, m))
    comp_v = torch.full((m + 1,), _INF, device=dev)
    comp_i = torch.full((m + 1,), -1, dtype=torch.int32, device=dev)
    comp_v[slot] = v
    comp_i[slot] = ix
    tv, ti = _prefix_tails(comp_v[:m], comp_i[:m], k1)
    return rank, tv[fill], ti[fill]


def _insert_bound(n: int, k1: int) -> int:
    """The reference's static capacity for the inserted subsequence of its
    buffer scan (beyond it the reference takes its full-replay branch):
    ~4x the padded harmonic bound k1 * (2 + ln(n / k1 + 1)), rounded up to
    the 128 quantum (floor 256, ceiling n). The port's scan sizes its
    replay by the true count and needs no such bound; it is kept to tell
    which inputs reach the reference's other branch."""
    exp = k1 * (2.0 + math.log(max(n, 2) / max(k1, 1) + 1.0))
    return min(n, max(256, -(-4 * int(exp) // 128) * 128))


def _group_last(sorted_w) -> torch.Tensor:
    """For each position of weights sorted descending, the position of the
    LAST element with the same weight (weight-group end): a right-side
    ``searchsorted`` of the negated, ascending weights into themselves.
    (The reference's reverse running min of group ends, as flip-cummin-
    flip, would be one single-row scan over all n on the card.)"""
    neg = (-sorted_w).contiguous()
    return torch.searchsorted(neg, neg, right=True) - 1


def universal_monotone_sample(keys, weights, active, k: int, seed=0, u=None,
                              device=None) -> UniversalSample:
    """S^(M,k) over a batch: one sort by (-w, u) + the buffer scan."""
    keys, w, act = keyed_inputs(keys, weights, active, device)
    act = act & (w > 0)
    u = (uniform01(keys, seed) if u is None
         else as_1d(u, torch.float32, w.device))
    n = w.shape[0]
    inf = torch.full_like(w, _INF)

    # inactive keys: pushed to the very end and never counted
    sort_w = torch.where(act, w, -inf)
    order = lexsort((u, -sort_w))       # primary: w descending; tie: u
    sw, su, sact = sort_w[order], u[order], act[order]

    rank, tail_v, tail_i = _buffer_scan(torch.where(sact, su, inf), order,
                                        k + 1)
    h = torch.clamp_max(rank, k + 1)
    s_member = sact & (rank < k)

    # p(w) at each weight-group end: (k+1)-th smallest u among all keys
    # with weight >= w (ties fully processed by the group end)
    gl = _group_last(sw)
    g_v, g_i = tail_v[gl], tail_i[gl]
    zero = torch.zeros_like(g_v)
    s_prob = torch.where(s_member, torch.where(torch.isfinite(g_v), g_v,
                                               torch.ones_like(g_v)), zero)
    marks = _scatter_mark(g_i, s_member & torch.isfinite(g_v), n)

    member = _unsort(order, s_member)
    return UniversalSample(member=member, prob=_unsort(order, s_prob),
                           aux=marks & ~member, h=_unsort(order, h))


def expected_size_bound(n: int, k: int) -> float:
    """Thm 5.1: E|S^(M,k)| <= sum_i min(1, k/i) < k (1 + ln n)."""
    return float(sum(min(1.0, k / i) for i in range(1, n + 1)))
