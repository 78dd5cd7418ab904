"""K6: all-pairs rank counts for universal sample membership.

Port of ``repro/kernels/rankcount.py``. Membership in the universal
samples is a rank condition:
  monotone (Lemma 5.1):  x in S^(M,k)  <=>  h_x < k,
      h_x = #{y : w_y >= w_x  and  u_y < u_x}
  capping  (Lemma 6.3):  x in S^(C,k)  <=>  h_x + l_x < k,
      l_x = #{y : w_y <  w_x  and  r_y/w_y < r_x/w_x}
both counted over the pairs where x and y are active.
``rank_counts_plain`` computes them pair by pair, chunked over x rows so
its memory stays bounded at n = 2^20. On the card they are 2-D dominance
counts: ``rank_counts_by_order`` orders the keys (one ``torch.sort`` of a
packed int64 key per count) so that only earlier keys can count, and the
kernel ``csrc/rankcount.cu`` counts, for each position of each order, the
earlier positions with a strictly smaller s, by a merge sort:
O(n log n) instead of n^2.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._util import (check_cuda, kernel_lib, meta_call,
                                       on_meta, raise_on_error, stream_ptr)

PLAIN_PAIRS = 1 << 24       # pairs the plain version compares at a time
_NOT_PART = torch.iinfo(torch.int64).max    # order key of a non-participant


def rank_counts_plain(weights, s_h, s_l, active, rows=None):
    """Plain PyTorch version of K6 (same comparisons, any device).

    ``rows``: optional int64 x indices; only their counts are computed
    (against every y), so a kernel run at n = 2^20 can be checked on a
    sample of its rows. Returns (h, l) int32 for ``rows`` (all x if None).
    """
    w = weights.to(torch.float32)
    act = active.to(torch.bool)
    sh = s_h.to(torch.float32)
    sl = s_l.to(torch.float32)
    n = w.shape[0]
    # an inactive y gets weight NaN: both weight comparisons are false
    wy = torch.where(act, w, torch.full_like(w, float("nan")))
    xs = (torch.arange(n, device=w.device) if rows is None
          else rows.to(device=w.device, dtype=torch.int64))
    h = torch.zeros(xs.shape, dtype=torch.int32, device=w.device)
    l = torch.zeros(xs.shape, dtype=torch.int32, device=w.device)
    step = max(1, PLAIN_PAIRS // max(n, 1))
    for i in range(0, xs.shape[0], step):
        x = xs[i:i + step]
        wx, hx, lx = w[x][:, None], sh[x][:, None], sl[x][:, None]
        h[i:i + step] = ((wy[None, :] >= wx) & (sh[None, :] < hx)).sum(
            1, dtype=torch.int32)
        l[i:i + step] = ((wy[None, :] < wx) & (sl[None, :] < lx)).sum(
            1, dtype=torch.int32)
    x_act = act[xs]
    return (torch.where(x_act, h, torch.zeros_like(h)),
            torch.where(x_act, l, torch.zeros_like(l)))


def _order_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32), ordered as the floats compare
    (-0.0 ties with +0.0; NaN is excluded by the caller)."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    b = x.view(torch.int32).to(torch.int64)
    return torch.where(b < 0, -1 - b, b + (1 << 31))


def _pack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) in [0, 2^32)^2 -> one int64 ordered lexicographically."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def earlier_smaller_plain(s_ord: torch.Tensor, pos: torch.Tensor,
                          step: int = 1024) -> torch.Tensor:
    """Plain counting core of ``rank_counts_by_order``: for s_ord [2, n]
    (each row in its order) the count of earlier entries with a strictly
    smaller s, chunked strict-< comparisons, written to out[r, pos[r, i]]."""
    n = s_ord.shape[1]
    cnt = torch.empty(s_ord.shape, dtype=torch.int32, device=s_ord.device)
    j = torch.arange(n, device=s_ord.device)
    for i0 in range(0, n, step):
        i = j[i0:i0 + step]
        smaller = ((s_ord[:, None, :] < s_ord[:, i0:i0 + step, None])
                   & (j[None, None, :] < i[None, :, None]))
        cnt[:, i0:i0 + step] = smaller.sum(-1, dtype=torch.int32)
    return torch.empty_like(cnt).scatter_(1, pos.to(torch.int64), cnt)


def rank_counts_by_order(weights, s_h, s_l, active, count):
    """(h, l) of ``rank_counts_plain`` from two orderings and a counting
    core ``count(s_ord [2, n] f32, pos [2, n] i32) -> [2, n] i32``.

    A key takes part in a count when it is active and neither its weight
    nor that count's s is NaN (every comparison with a NaN is false, so
    such a key neither counts nor is counted). Order h's keys by (w
    descending, s_h ascending): a key y before x has w_y > w_x, or
    w_y == w_x and s_h,y <= s_h,x; every y with w_y >= w_x and
    s_h,y < s_h,x comes before x. Order l's by (w ascending, s_l
    descending): y before x has w_y < w_x, or w_y == w_x and s_l,y >=
    s_l,x, which never counts. In both, x's count is the number of earlier
    keys with a strictly smaller s. Non-participants go last with s = +inf
    and get 0.
    """
    w = weights.to(torch.float32)
    act = active.to(torch.bool)
    sh = s_h.to(torch.float32)
    sl = s_l.to(torch.float32)
    ok = act & ~torch.isnan(w)
    s = torch.stack([sh, sl])
    part = ok & ~torch.isnan(s)                                  # [2, n]
    ow = _order_bits(torch.where(ok, w, torch.zeros_like(w)))
    os_ = _order_bits(torch.where(part, s, torch.zeros_like(s)))
    top = (1 << 32) - 1
    key = torch.stack([_pack(top - ow, os_[0]), _pack(ow, top - os_[1])])
    key = torch.where(part, key, torch.full_like(key, _NOT_PART))
    order = torch.sort(key, dim=1).indices
    s = torch.where(part, s, torch.full_like(s, float("inf")))
    counts = count(torch.gather(s, 1, order).contiguous(),
                   order.to(torch.int32).contiguous())
    counts = torch.where(part, counts, torch.zeros_like(counts))
    return counts[0], counts[1]


def _earlier_smaller_kernel(s_ord: torch.Tensor, pos: torch.Tensor):
    """The counting core on the card: csrc/rankcount.cu."""
    n = s_ord.shape[1]
    out = torch.empty((2, n), dtype=torch.int32, device=s_ord.device)
    scratch = torch.empty((24 * n,), dtype=torch.int32, device=s_ord.device)
    code = kernel_lib().repro_rankcount(
        s_ord.data_ptr(), pos.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        n, stream_ptr(s_ord.device))
    rank_counts.launches += 1
    raise_on_error("rankcount", code)
    return out


def rank_counts(weights, s_h, s_l, active):
    """weights, s_h, s_l float32 and active bool [n] -> (h, l) int32 [n]:
    h against the order statistic s_h (u), l against s_l (r/w). The
    diagonal never self-counts (strict s_y < s_x). CPU tensors take the
    plain version; CUDA tensors go through ``rank_counts_by_order`` and
    the kernel (counted once per call in ``rank_counts.launches``)."""
    if weights.device.type == "cpu":
        return rank_counts_plain(weights, s_h, s_l, active)
    n = weights.shape[0]
    if on_meta(weights):            # shapes and bytes only
        return meta_call("rankcount", (weights, s_h, s_l, active), tuple(
            torch.empty((n,), dtype=torch.int32, device="meta")
            for _ in range(2)))
    check_cuda("weights", weights, torch.float32, (n,))
    check_cuda("s_h", s_h, torch.float32, (n,))
    check_cuda("s_l", s_l, torch.float32, (n,))
    check_cuda("active", active, torch.bool, (n,))
    if n == 0:
        empty = torch.empty((0,), dtype=torch.int32, device=weights.device)
        return empty, empty.clone()
    return rank_counts_by_order(weights, s_h, s_l, active,
                                _earlier_smaller_kernel)


rank_counts.launches = 0
