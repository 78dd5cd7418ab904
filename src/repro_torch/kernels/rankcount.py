"""K6: all-pairs rank counts for universal sample membership.

Port of ``repro/kernels/rankcount.py``. Membership in the universal
samples is a rank condition:
  monotone (Lemma 5.1):  x in S^(M,k)  <=>  h_x < k,
      h_x = #{y : w_y >= w_x  and  u_y < u_x}
  capping  (Lemma 6.3):  x in S^(C,k)  <=>  h_x + l_x < k,
      l_x = #{y : w_y <  w_x  and  r_y/w_y < r_x/w_x}
both counted over the pairs where x and y are active. The CUDA kernel is
``csrc/rankcount.cu`` (one thread per x, y tiles in shared memory);
``rank_counts_plain`` is its plain PyTorch version, chunked over x rows
so its memory stays bounded at n = 2^20.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._util import (check_cuda, kernel_lib,
                                       raise_on_error, stream_ptr)

PLAIN_PAIRS = 1 << 24       # pairs the plain version compares at a time


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


def rank_counts(weights, s_h, s_l, active):
    """weights, s_h, s_l float32 and active bool [n] -> (h, l) int32 [n]:
    h against the order statistic s_h (u), l against s_l (r/w). The
    diagonal never self-counts (strict s_y < s_x). CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    ``rank_counts.launches``)."""
    if weights.device.type == "cpu":
        return rank_counts_plain(weights, s_h, s_l, active)
    n = weights.shape[0]
    check_cuda("weights", weights, torch.float32, (n,))
    check_cuda("s_h", s_h, torch.float32, (n,))
    check_cuda("s_l", s_l, torch.float32, (n,))
    check_cuda("active", active, torch.bool, (n,))
    h = torch.empty((n,), dtype=torch.int32, device=weights.device)
    l = torch.empty((n,), dtype=torch.int32, device=weights.device)
    if n == 0:
        return h, l
    code = kernel_lib().repro_rankcount(
        weights.data_ptr(), s_h.data_ptr(), s_l.data_ptr(),
        active.data_ptr(), h.data_ptr(), l.data_ptr(), n,
        stream_ptr(weights.device))
    rank_counts.launches += 1
    raise_on_error("rankcount", code)
    return h, l


rank_counts.launches = 0
