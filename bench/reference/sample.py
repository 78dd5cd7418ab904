"""Plain reference of the sampled gradient exchange's per-leaf sample: the
paper's multi-objective bottom-k sample of one gradient leaf, as the
3k-slot wire slab that a pod sends.

  keys    the coordinate's position in the flattened leaf (int32);
  w       |g| / max |g|;
  u       the top 24 bits of a 32-bit hash of (key, seed) (MurmurHash3's
          finalizer, applied twice), shifted by half a step into (0, 1);
  seeds   per objective f in F = (sum, cap_c, count): -ln(1 - u) / f(w),
          +inf where f(w) = 0 (ppswor);
  member  seed <= the k-th smallest seed of its objective, for any f;
  slots   the first 3k members in key order, then padding (key -1,
          weight 0, probability 1, not valid);
  probs   max over the objectives that hold the key of 1 - exp(-f(w) tau),
          tau the (k+1)-th smallest seed;
  weights the signed gradient entries.

Seeds are made and scanned in blocks of ``block`` keys, so a leaf of 700 M
rows needs a few hundred MB beside its gradient. Imports nothing of the
program.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_GOLDEN, _C1, _C2 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def _fmix(h):
    h = h ^ (h >> 16)
    h = (h * _C1) & M32
    h = h ^ (h >> 13)
    h = (h * _C2) & M32
    return h ^ (h >> 16)


def uniform(keys: torch.Tensor, seed: int) -> torch.Tensor:
    """u in (0, 1) of int64 keys, float32."""
    s = int(seed) & M32
    h = _fmix((keys + _GOLDEN + s) & M32)
    h = _fmix(h ^ ((s * _C1 + 1) & M32))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 0.5 / (1 << 24)


def exchange_seed(base: int, leaf_index: int, pod: int, step: int) -> int:
    """The seed of leaf ``leaf_index`` (its place among all the gradient
    leaves in sorted-path order) of pod ``pod`` at optimizer step
    ``step`` (0 for the first)."""
    return (base + leaf_index * 1_000_003 + pod * 7919 + step) & M32


def _fvals(w, cap):
    return (w, torch.clamp_max(w, cap), (w > 0).to(torch.float32))


def _seeds(keys, wk, seed, cap):
    """[3, len(keys)] seeds of int64 keys whose weights are wk."""
    r = -torch.log1p(-uniform(keys, seed))
    inf = torch.tensor(float("inf"), device=wk.device)
    return torch.stack([torch.where(f > 0, r / torch.clamp_min(f, 1e-30), inf)
                        for f in _fvals(wk, cap)])


def _block(w, lo, hi, seed, cap):
    keys = torch.arange(lo, hi, dtype=torch.int64, device=w.device)
    return _seeds(keys, w[lo:hi], seed, cap)


def sample(g: torch.Tensor, k: int, seed: int, cap: float,
           block: int = 1 << 26) -> dict:
    """The wire slab of one leaf: {keys, weights, probs, valid}, each
    [min(3k, n)]."""
    flat = g.reshape(-1).to(torch.float32)
    n = flat.numel()
    w = flat.abs()
    w = w / torch.clamp_min(w.max(), 1e-30)
    kk = min(k, n)
    best = None
    for lo in range(0, n, block):
        s = _block(w, lo, min(lo + block, n), seed, cap)
        low = torch.topk(s, min(kk + 1, s.shape[1]), dim=1,
                         largest=False).values
        best = low if best is None else torch.topk(
            torch.cat([best, low], 1), min(kk + 1, best.shape[1]
                                           + low.shape[1]),
            dim=1, largest=False).values
    vals = torch.sort(best, dim=1).values
    if vals.shape[1] < kk + 1:
        vals = torch.nn.functional.pad(vals, (0, kk + 1 - vals.shape[1]),
                                       value=float("inf"))
    kth, tau = vals[:, kk - 1], vals[:, kk]
    slots = min(3 * k, n)
    take = []
    have = 0
    for lo in range(0, n, block):
        if have >= slots:
            break
        s = _block(w, lo, min(lo + block, n), seed, cap)
        hit = ((s <= kth[:, None]) & torch.isfinite(s)).any(0)
        idx = hit.nonzero().squeeze(1) + lo
        take.append(idx[:slots - have])
        have += take[-1].numel()
    take = torch.cat(take)
    m = take.numel()
    pad = slots - m
    st = _seeds(take, w[take], seed, cap)
    fv = torch.stack(_fvals(w[take], cap))
    held = (st <= kth[:, None]) & torch.isfinite(st)
    t = fv * tau[:, None]
    p = torch.where(torch.isinf(t), torch.ones_like(t), -torch.expm1(-t))
    probs = torch.where(held, p, torch.zeros_like(p)).amax(0)
    z = lambda v, dt: torch.full((pad,), v, dtype=dt, device=w.device)
    return {"keys": torch.cat([take.to(torch.int32), z(-1, torch.int32)]),
            "weights": torch.cat([flat[take], z(0.0, torch.float32)]),
            "probs": torch.cat([probs, z(1.0, torch.float32)]),
            "valid": torch.cat([torch.ones(m, dtype=torch.bool,
                                           device=w.device),
                                z(False, torch.bool)])}
