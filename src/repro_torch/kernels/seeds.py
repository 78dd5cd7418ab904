"""K1: fused f-seeds (+ f-values) for every objective, one launch.

Port of ``repro/kernels/seeds.py``: hash(key, seed) -> u -> r
(ppswor: -log1p(-u), priority: u) -> per objective j the seed r / f_j(w)
(+inf if inactive or f_j(w) = 0) and f_j(w) masked to 0 on inactive keys.
Objectives are (kind, param) pairs: 0=sum, 1=count, 2=thresh(T), 3=cap(T),
4=moment(p). The CUDA kernel is ``csrc/seeds.cu``; ``fused_seeds_fvals_plain``
is its plain PyTorch version, which runs for CPU tensors. ``fused_seeds``
writes the seeds alone, as the reference's does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.funcs import moment_pow
from repro_torch.core.hashing import uniform01
from repro_torch.kernels._util import (check_cuda, kernel_lib, meta_call,
                                       objective_arrays, on_meta,
                                       raise_on_error, stream_ptr)

_SCHEMES = ("ppswor", "priority")


def fval(kind: int, param: float, w: torch.Tensor) -> torch.Tensor:
    """f(w) for one (kind, param) objective, float32."""
    if kind == 0:
        return w
    if kind == 1:
        return (w > 0).to(torch.float32)
    if kind == 2:
        return (w >= param).to(torch.float32)
    if kind == 3:
        return torch.clamp_max(w, param)
    return moment_pow(w, param)


def fused_seeds_fvals_plain(keys, weights, active, objectives,
                            scheme="ppswor", seed=0, want_fvals=True):
    """Plain PyTorch version of K1 (same arithmetic, any device). Without
    ``want_fvals`` the f-values are neither kept nor returned:
    (seeds, None)."""
    w = weights.to(torch.float32)
    act = active.to(torch.bool)
    u = uniform01(keys, seed)
    r = -torch.log1p(-u) if scheme == "ppswor" else u
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=w.device)
    seeds, fvals = [], []
    for kind, param in objectives:
        fv = fval(kind, param, w)
        ok = act & (fv > 0)
        seeds.append(torch.where(ok, r / torch.clamp_min(fv, 1e-30), inf))
        if want_fvals:
            fvals.append(torch.where(act, fv, torch.zeros_like(fv)))
    return torch.stack(seeds), torch.stack(fvals) if want_fvals else None


def seeds_and_fvals(keys, weights, active, objectives, scheme="ppswor",
                    seed=0, want_fvals=True):
    """keys int32, weights float32, active bool [n] -> (seeds [F, n],
    fvals [F, n] or None without ``want_fvals``) float32. CPU tensors take
    the plain version; CUDA tensors launch the kernel (counted in
    ``fused_seeds_fvals.launches``), which then writes no f-values at
    all; meta tensors give the outputs' shapes and book the kernel's
    bytes (``_util.meta_call``)."""
    if scheme not in _SCHEMES:
        raise ValueError(
            f"unknown scheme {scheme!r} (want 'priority' or 'ppswor')")
    objectives = tuple((int(k), float(p)) for k, p in objectives)
    if keys.device.type == "cpu":
        return fused_seeds_fvals_plain(keys, weights, active, objectives,
                                       scheme, seed, want_fvals)
    n = keys.shape[0]
    if on_meta(keys):
        out = torch.empty((len(objectives), n), dtype=torch.float32,
                          device="meta")
        outs = (out, torch.empty_like(out)) if want_fvals else (out,)
        got = meta_call("seeds", (keys, weights, active), outs)
        return got[0], got[1] if want_fvals else None
    check_cuda("keys", keys, torch.int32, (n,))
    check_cuda("weights", weights, torch.float32, (n,))
    check_cuda("active", active, torch.bool, (n,))
    nf = len(objectives)
    seeds = torch.empty((nf, n), dtype=torch.float32, device=keys.device)
    fvals = (torch.empty((nf, n), dtype=torch.float32, device=keys.device)
             if want_fvals else None)
    if n == 0:
        return seeds, fvals
    kinds, params = objective_arrays(objectives)
    code = kernel_lib().repro_seeds(
        keys.data_ptr(), weights.data_ptr(), active.data_ptr(),
        seeds.data_ptr(), None if fvals is None else fvals.data_ptr(), n,
        nf, ctypes.addressof(kinds), ctypes.addressof(params),
        int(seed) & 0xFFFFFFFF, 1 if scheme == "ppswor" else 0,
        stream_ptr(keys.device))
    fused_seeds_fvals.launches += 1
    raise_on_error("seeds", code)
    return seeds, fvals


def fused_seeds_fvals(keys, weights, active, objectives, scheme="ppswor",
                      seed=0):
    """(seeds [F, n], fvals [F, n]) in one launch (``seeds_and_fvals``)."""
    return seeds_and_fvals(keys, weights, active, objectives, scheme, seed)


fused_seeds_fvals.launches = 0


def fused_seeds(keys, weights, active, objectives, scheme="ppswor", seed=0):
    """Seeds only: [n] -> [F, n]; no f-value array is allocated or
    written."""
    return seeds_and_fvals(keys, weights, active, objectives, scheme, seed,
                           want_fvals=False)[0]
