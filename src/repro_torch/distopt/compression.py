"""Sampled gradient exchange: the paper's technique in place of the dense
cross-pod all-reduce.

Port of ``repro/distopt/compression.py``. Each pod communicates a
FIXED-SIZE multi-objective bottom-k sample of its gradient:

  keys    = the coordinate's position in the flattened leaf;
  weights = |g_i| / max |g| (the sketch's ``weights`` slab carries the
            SIGNED entries, so the HT merge reads contributions off the
            wire);
  F       = {(sum, k), (cap_c, k), (count, k)}: one coordinated sample
            serves the gradient estimate (sum), heavy-hitter-robust mass
            (cap) and support statistics (count);
  wire    = a 3k-slot slab per leaf (keys, weights, probs, valid),
            gathered over the pod group;
  merge   = a pod's own share stays EXACT; the other pods' are HT
            estimates: (total - est_self + own_g) / npods, the pods added
            in index order. Pods' parameters therefore drift apart by
            design, as in the reference.

Within a pod the gradients are averaged densely over the ``data`` group
first (``launch/steps.py``); leaves under ``min_size`` elements are
averaged densely over the pod group too. A placed gradient is exchanged
block by block, as the reference's ``shard_map`` over every axis does:
each rank samples its own block (keys are positions in the flattened
block, the dense/sampled choice tests the block's size, the seed is the
same for every block of a pod) and the gather runs over ``pod`` only. Each leaf is reseeded by its
index in sorted-key flatten order, the pod and the step, wrapping mod 2^32
as the reference's uint32 sum does.

Selection runs K1 in its seeds-only mode, then K2 (``use_kernels``; their
plain versions otherwise). Only the <= 3k member slots need f-values and
probabilities, so those are formed after the members are known: at 385M
rows this saves the [F, n] f-value and probability arrays. Members are
gathered with ``torch.nonzero_static`` (index order, as the reference's
stable ``argsort(~member)``, in O(n) instead of a sort of n keys; its
shape is fixed by the slots, so the exchange also runs on meta tensors);
the slots past the members are padding whose every field is masked.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.core import COUNT, SUM, cap, conditional_prob
from repro_torch.core.multi_sketch import MultiSketch, MultiSketchSpec
from repro_torch.launch.mesh import all_gather, all_reduce_mean_

_M32 = 0xFFFFFFFF


def _leaf_spec(k: int, cap_frac: float, scheme: str) -> MultiSketchSpec:
    """The coordinated objective set F of the gradient exchange."""
    return MultiSketchSpec(
        objectives=((SUM, k), (cap(cap_frac), k), (COUNT, k)),
        scheme=scheme, capacity=3 * k)


def _select(spec, keys, wn, act, seed: int, use_kernels: bool):
    """(seeds [F, n], kth [F], taus [F]): K1 (seeds only), then K2."""
    from repro_torch.kernels.blockselect import (
        batched_bottomk_select, batched_bottomk_select_plain)
    from repro_torch.kernels.seeds import (fused_seeds,
                                           fused_seeds_fvals_plain)
    n = keys.shape[0]
    kks = [min(kf, n) for _, kf in spec.objectives]
    kmax = max(kks)
    enc = spec.kernel_objectives()
    if use_kernels:
        seeds = fused_seeds(keys, wn, act, enc, spec.scheme, seed)
        vals, _, _ = batched_bottomk_select(seeds, kmax + 1)
    else:
        seeds, _ = fused_seeds_fvals_plain(keys, wn, act, enc, spec.scheme,
                                           seed, want_fvals=False)
        vals, _, _ = batched_bottomk_select_plain(seeds, kmax + 1)
    if vals.shape[1] < kmax + 1:             # n <= kmax: no (k+1)-th seed
        vals = torch.nn.functional.pad(vals, (0, kmax + 1 - vals.shape[1]),
                                       value=float("inf"))
    rows = torch.arange(spec.nf, device=keys.device)
    kk = torch.tensor(kks, device=keys.device)
    return seeds, vals[rows, kk - 1], vals[rows, kk]


def _sample_leaf(g, k: int, seed: int, cap_frac: float,
                 scheme: str = "ppswor",
                 use_kernels: bool = True) -> MultiSketch:
    """Multi-objective bottom-k sample of one gradient leaf as a 3k-slot
    MultiSketch wire slab (members first, in index order; aux dropped:
    pods hold disjoint key spaces, so only members carry HT mass). The
    keys are int32 positions: a leaf (or block) of 2^31 rows or more
    raises ``ValueError`` rather than wrap."""
    n = g.numel()
    if n >= 2 ** 31:
        raise ValueError(f"a gradient leaf of {n:,} rows is past the "
                         f"exchange's int32 keys (at most 2^31 - 1 rows)")
    flat = g.reshape(-1).to(torch.float32)
    dev = flat.device
    wn = torch.abs(flat)
    wn.div_(torch.clamp_min(torch.max(wn), 1e-30))  # weights in (0, 1]
    act = wn > 0
    spec = _leaf_spec(min(k, n), cap_frac, scheme)
    seeds, kth, taus = _select(
        spec, torch.arange(n, dtype=torch.int32, device=dev), wn, act,
        int(seed) & _M32, use_kernels)
    member = torch.zeros((n,), dtype=torch.bool, device=dev)
    for f in range(spec.nf):
        member |= (seeds[f] <= kth[f]) & torch.isfinite(seeds[f])
    slots = min(spec.cap, n)         # a leaf under 3k rows has n slots
    take = torch.nonzero_static(member, size=slots, fill_value=0
                                ).reshape(-1)
    valid = torch.arange(slots, device=dev) < member.sum()
    st = seeds[:, take]
    del seeds, member
    wt, at = wn[take], act[take]
    fv = torch.stack([torch.where(at, f(wt), torch.zeros_like(wt))
                      for f, _ in spec.objectives])
    member_f = (st <= kth[:, None]) & torch.isfinite(st)
    p = torch.where(member_f, conditional_prob(fv, taus[:, None],
                                               spec.scheme),
                    torch.zeros_like(fv)).amax(dim=0)
    return MultiSketch(
        keys=torch.where(valid, take.to(torch.int32),
                         torch.full_like(take, -1, dtype=torch.int32)),
        weights=torch.where(valid, flat[take], torch.zeros_like(wt)),
        probs=torch.where(valid, p, torch.ones_like(p)),
        seeds=torch.where(valid[None, :], st, torch.full_like(st, float(
            "inf"))),
        member=valid,
        aux=torch.zeros_like(valid),
        valid=valid,
        taus=taus)


def _contrib(val, prob, valid):
    return torch.where(valid, val / torch.clamp_min(prob, 1e-30),
                       torch.zeros_like(val))


def _merge_leaf(idx, val, prob, valid, n: int, npods: int):
    """HT estimate of the mean gradient from gathered per-pod slabs (the
    all-sampled variant)."""
    dense = torch.zeros((n,), dtype=torch.float32, device=val.device)
    dense.index_add_(0, torch.clamp_min(idx, 0).reshape(-1).to(torch.int64),
                     _contrib(val, prob, valid).reshape(-1))
    return dense / npods


def _wire(sk: MultiSketch) -> torch.Tensor:
    """The four gathered fields as one int32 [4, slots] block (floats by
    their bits)."""
    return torch.stack([sk.keys, sk.weights.view(torch.int32),
                        sk.probs.view(torch.int32), sk.valid.to(torch.int32)])


def _unwire(w: torch.Tensor):
    """[..., 4, slots] int32 -> (keys, weights, probs, valid)."""
    return (w[..., 0, :], w[..., 1, :].view(torch.float32),
            w[..., 2, :].view(torch.float32), w[..., 3, :].to(torch.bool))


def _merge_own(g, gathered, pod: int):
    """(total - est_self + own_g) / npods for one leaf: total adds the
    pods' HT estimates in index order. Each pod's slab holds distinct
    keys (padding adds +0 at key 0), so scatter-adding into one buffer
    gives the reference's bits."""
    flat_g = g.reshape(-1).to(torch.float32)
    npods = gathered.shape[0]
    gi, gv, gp, gm = _unwire(gathered)
    total = torch.zeros_like(flat_g)
    idx = torch.clamp_min(gi, 0).to(torch.int64)
    for p in range(npods):
        total.index_add_(0, idx[p], _contrib(gv[p], gp[p], gm[p]))
    total.index_add_(0, idx[pod], -_contrib(gv[pod], gp[pod], gm[pod]))
    return total.add_(flat_g).div_(npods).reshape(g.shape).to(g.dtype)


def exchange_grads(mesh, grads, step: int, *, axis: str = "pod",
                   k: int = 512, cap_frac: float = 0.01, seed: int = 17,
                   min_size: int = 65536, return_wires: bool = False):
    """The sampled cross-pod exchange of a pod-local gradient tree (each
    leaf this rank's block, contiguous): every
    leaf of >= ``min_size`` elements is sampled, the slabs of all such
    leaves are gathered over the pod group in one collective, and each
    leaf becomes (total - est_self + own_g) / npods; smaller leaves are
    averaged densely (one collective). The top-level dict passed in is
    emptied, so each input leaf is released once its output exists (a
    caller that keeps its own reference to a leaf keeps the leaf).
    ``return_wires``: also {path: gathered [npods, 4, 3k] int32}."""
    pod = mesh.coords[axis]
    flat = T.flatten(grads)
    grads.clear()
    wires, dense = {}, []
    for j, (path, g) in enumerate(flat):
        if g.numel() < min_size:
            dense.append(path)
            continue
        s = (seed + j * 1_000_003 + pod * 7919 + int(step)) & _M32
        wires[path] = _wire(_sample_leaf(g, k, s, cap_frac))
    out = {}
    if wires:
        paths = list(wires)
        gathered = all_gather(mesh, axis, torch.stack([wires[p]
                                                       for p in paths]))
        wires = {p: gathered[:, i] for i, p in enumerate(paths)}
    if dense:
        small = dict(flat)
        packed = torch.cat([small[p].reshape(-1).to(torch.float32)
                            for p in dense])
        packed = all_reduce_mean_(mesh, axis, packed)
        off = 0
        for p in dense:
            x = small[p]
            out[p] = packed[off:off + x.numel()].reshape(x.shape).to(x.dtype)
            off += x.numel()
        del small
    for i, (path, g) in enumerate(flat):
        if path in wires:
            flat[i] = (path, None)
            out[path] = _merge_own(g, wires[path], pod)
            del g
    result = T.unflatten((p, out[p]) for p, _ in flat)
    return (result, wires) if return_wires else result


def compressed_grads_fn(compute_grads, mesh, *, axis: str = "pod",
                        k: int = 512, cap_frac: float = 0.01, seed: int = 17,
                        min_size: int = 65536):
    """Wrap ``compute_grads(params, batch) -> (loss, metrics, grads)``,
    which returns this pod's gradients (already averaged over the data
    group), so that the cross-POD reduction is the sampled exchange
    instead of a dense all-reduce. Returns None on meshes without the
    axis."""
    if axis not in mesh.axis_names:
        return None

    def wrapped(params, batch, step):
        loss, metrics, grads = compute_grads(params, batch)
        names = sorted(metrics)
        packed = all_reduce_mean_(mesh, axis, torch.stack(
            [loss.to(torch.float32)] + [metrics[m].to(torch.float32)
                                        for m in names]))
        loss = packed[0]
        metrics = {m: packed[i + 1] for i, m in enumerate(names)}
        grads = exchange_grads(mesh, grads, int(step), axis=axis, k=k,
                               cap_frac=cap_frac, seed=seed,
                               min_size=min_size)
        return loss, metrics, grads

    return wrapped
