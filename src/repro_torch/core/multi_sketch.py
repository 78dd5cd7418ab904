"""MultiSketch: the mergeable fixed-capacity multi-objective summary.

Port of ``repro/core/multi_sketch.py``. Wire format (a NamedTuple of
tensors on one device):

  keys    int32   [c]      key ids, -1 on empty slots
  weights float32 [c]      w_x (merged data sets: max over occurrences)
  probs   float32 [c]      p_x^(F) = max_f p_x^(f) for members, else 0
  seeds   float32 [nf, c]  per-objective f-seeds r_x / f(w_x) (+inf invalid)
  member  bool    [c]      x ∈ S^(F)
  aux     bool    [c]      x ∈ Z (every objective's threshold key)
  valid   bool    [c]      slot occupied
  taus    float32 [nf]     tau^(f,k_f): the (k_f+1)-th smallest f-seed

Threshold closure (Z keeps every objective's threshold key) makes
re-selection over the concatenated retained keys of any parts exact, so
build, absorb, absorb_slabs, merge and merge_stacked all agree with a
one-shot build over the union. ``multisketch_finalize`` recomputes
``probs`` at the fixed shape [c] at every producer, so equal retained
state gives bit-equal slabs whatever path produced it.

Every fold allocates a fresh slab (the reference donates buffers; the
slab is a few hundred KB, so in-place reuse would save nothing), which
also means a slab handed to a caller is never invalidated by a later fold.

``use_kernels`` (default True) routes selection and compaction through the
kernel wrappers K1-K3, which run the CUDA kernels for CUDA tensors and
their plain versions for CPU tensors; ``use_kernels=False`` is the plain
selection path (one stable sort per objective row), the reference's XLA
twin.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import as_1d, device_of, lexsort, resolve_device
from .bottomk import conditional_prob, f_seed
from .estimators import estimate_many
from .funcs import StatFn
from .hashing import uniform01
from .predicates import encode_predicates, pad_table, predicate_matrix

_INF = float("inf")

# StatFn kind -> kernel objective code (kernels/seeds.py)
_KERNEL_KIND = {"sum": 0, "count": 1, "thresh": 2, "cap": 3, "moment": 4}


@dataclasses.dataclass(frozen=True)
class MultiSketchSpec:
    """Static half of a MultiSketch. Two sketches are mergeable iff their
    specs are equal: same objectives (f, k_f) in order, scheme, hash seed."""

    objectives: Tuple[Tuple[StatFn, int], ...]
    scheme: str = "ppswor"
    seed: int = 0
    capacity: int = 0  # 0 -> default_capacity()

    def __post_init__(self):
        if self.scheme not in ("priority", "ppswor"):
            raise ValueError(
                f"unknown scheme {self.scheme!r} (want 'priority' or "
                f"'ppswor')")
        object.__setattr__(self, "objectives",
                           tuple((f, int(k)) for f, k in self.objectives))

    @property
    def nf(self) -> int:
        return len(self.objectives)

    @property
    def kmax(self) -> int:
        return max(k for _, k in self.objectives)

    def default_capacity(self) -> int:
        """sum_f k_f + |F| bounds |S^(F) ∪ Z|; the +1 spare slot keeps
        ``multisketch_overflow`` False whenever exactness holds."""
        return sum(k for _, k in self.objectives) + self.nf + 1

    @property
    def cap(self) -> int:
        return self.capacity if self.capacity > 0 else self.default_capacity()

    def kernel_objectives(self) -> Optional[Tuple[Tuple[int, float], ...]]:
        """(kind, param) encoding for the kernels; None if any objective
        (e.g. combo) has none."""
        enc = []
        for f, _ in self.objectives:
            kind = _KERNEL_KIND.get(f.kind)
            if kind is None:
                return None
            enc.append((kind, float(f.param)))
        return tuple(enc)


class MultiSketch(NamedTuple):
    """Array half of the summary; see the module docstring."""

    keys: torch.Tensor     # int32 [c]
    weights: torch.Tensor  # float32 [c]
    probs: torch.Tensor    # float32 [c]
    seeds: torch.Tensor    # float32 [nf, c]
    member: torch.Tensor   # bool [c]
    aux: torch.Tensor      # bool [c]
    valid: torch.Tensor    # bool [c]
    taus: torch.Tensor     # float32 [nf]


def multisketch_empty(spec: MultiSketchSpec, device=None) -> MultiSketch:
    """The identity element of ``merge``/``absorb``."""
    dev = resolve_device(device)
    c, nf = spec.cap, spec.nf
    return MultiSketch(
        keys=torch.full((c,), -1, dtype=torch.int32, device=dev),
        weights=torch.zeros((c,), dtype=torch.float32, device=dev),
        probs=torch.zeros((c,), dtype=torch.float32, device=dev),
        seeds=torch.full((nf, c), _INF, dtype=torch.float32, device=dev),
        member=torch.zeros((c,), dtype=torch.bool, device=dev),
        aux=torch.zeros((c,), dtype=torch.bool, device=dev),
        valid=torch.zeros((c,), dtype=torch.bool, device=dev),
        taus=torch.full((nf,), _INF, dtype=torch.float32, device=dev))


def multisketch_slab_bytes(spec: MultiSketchSpec) -> int:
    """Size of ONE slab in bytes: keys/weights/probs (3 x 4c) + seeds
    (4 nf c) + member/aux/valid (3 c) + taus (4 nf)."""
    c, nf = spec.cap, spec.nf
    return c * (15 + 4 * nf) + 4 * nf


# ---------------------------------------------------------------------------
# selection (member/prob/aux/taus over a fixed-shape batch)
# ---------------------------------------------------------------------------

def multisketch_select(spec: MultiSketchSpec, keys, weights, active,
                       use_kernels: bool = False, seed=None):
    """Multi-objective bottom-k selection with the mergeable aux set.

    Returns (member [n], prob [n] = p^(F), aux [n], seeds [nf, n],
    taus [nf]); aux holds the threshold key of every objective. ``seed``
    overrides spec.seed (and takes the plain selection path).
    """
    n = keys.shape[0]
    nf = spec.nf
    dev = keys.device
    kks = [min(kf, n) for _, kf in spec.objectives]
    kmax = max(kks)
    seed = spec.seed if seed is None else seed

    enc = spec.kernel_objectives()
    if use_kernels and enc is not None:
        # imported here: the kernel modules import this package's primitives
        from repro_torch.kernels.blockselect import batched_bottomk_select
        from repro_torch.kernels.seeds import fused_seeds_fvals
        seeds, fvals = fused_seeds_fvals(keys, weights, active, enc,
                                         spec.scheme, int(seed))
        vals, idx, _ = batched_bottomk_select(seeds, kmax + 1)
    else:
        u = uniform01(keys, seed)
        seeds = torch.stack([f_seed(weights, active, f, u, spec.scheme)
                             for f, _ in spec.objectives])
        fvals = torch.stack([torch.where(active, f(weights),
                                         torch.zeros_like(weights))
                             for f, _ in spec.objectives])
        m = min(kmax + 2, n)
        # stable ascending sort == lax.top_k(-x) with lowest index first
        vals, idx = torch.sort(seeds, dim=1, stable=True)
        vals, idx = vals[:, :m], idx[:, :m].to(torch.int32)

    if vals.shape[1] < kmax + 1:             # n <= kmax: no (k+1)-th seed
        pad = kmax + 1 - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=_INF)
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    rows = torch.arange(nf, device=dev)
    kk = torch.tensor(kks, device=dev)
    kth = vals[rows, kk - 1]                                     # [nf]
    taus = vals[rows, kk]                                        # [nf]
    thr_idx = idx[rows, kk]                                      # [nf]

    member_f = (seeds <= kth[:, None]) & torch.isfinite(seeds)
    p_f = torch.where(member_f,
                      conditional_prob(fvals, taus[:, None], spec.scheme),
                      torch.zeros_like(fvals))
    member = member_f.any(dim=0)
    prob = torch.where(member, p_f.amax(dim=0), torch.zeros_like(weights))

    # Z: the (k_f+1)-th smallest-seed key of every objective (if it exists);
    # out-of-range index n lands in a spare slot that is sliced away
    safe = torch.where(torch.isfinite(taus) & (thr_idx >= 0),
                       thr_idx.to(torch.int64),
                       torch.full_like(thr_idx, n, dtype=torch.int64))
    aux = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    aux[safe] = True
    aux = aux[:n] & ~member
    return member, prob, aux, seeds, taus


def _compact(spec: MultiSketchSpec, keys, weights, member, prob, aux, seeds,
             taus, use_kernels: bool) -> MultiSketch:
    """Compact S^(F) ∪ Z into the fixed-capacity slab (members by weight
    desc first, then aux)."""
    c = spec.cap
    keep = member | aux
    if use_kernels:
        from repro_torch.kernels.compact import compact_take
        take, tvalid = compact_take(keys, weights, member, keep, c)
    else:
        inv = 1.0 / (1.0 + torch.clamp_min(weights, 0.0))
        pri = torch.where(keep & (keys >= 0),
                          torch.where(member, inv, 2.0 + inv),
                          torch.full_like(inv, _INF))
        n = pri.shape[0]
        if n < c:
            pri = torch.nn.functional.pad(pri, (0, c - n), value=_INF)
        sv, take = torch.sort(pri, stable=True)
        sv, take = sv[:c], take[:c]
        tvalid = torch.isfinite(sv) & (take < n)
    tk = torch.where(tvalid, take.to(torch.int64),
                     torch.zeros_like(take, dtype=torch.int64))
    return MultiSketch(
        keys=torch.where(tvalid, keys[tk], torch.full_like(keys[tk], -1)),
        weights=torch.where(tvalid, weights[tk], torch.zeros_like(
            weights[tk])),
        probs=torch.where(tvalid, prob[tk], torch.zeros_like(prob[tk])),
        seeds=torch.where(tvalid[None, :], seeds[:, tk],
                          torch.full_like(seeds[:, tk], _INF)),
        member=member[tk] & tvalid,
        aux=aux[tk] & tvalid,
        valid=tvalid,
        taus=taus)


def _rebuild(spec: MultiSketchSpec, keys, weights, valid,
             use_kernels: bool) -> MultiSketch:
    """Dedup (keep max weight), re-select, compact: the shared exact-merge
    core of absorb and merge."""
    # the reference's lexsort((-w, ~valid, keys)): key asc, VALID first,
    # weight desc
    order = lexsort((-weights, (~valid).to(torch.uint8), keys))
    sk, sw, sv = keys[order], weights[order], valid[order]
    dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=sk.device),
                     sk[1:] == sk[:-1]])
    act = sv & ~dup & (sk >= 0)
    member, prob, aux, seeds, taus = multisketch_select(
        spec, sk, sw, act, use_kernels=use_kernels)
    return _compact(spec, sk, sw, member, prob, aux, seeds, taus,
                    use_kernels)


# ---------------------------------------------------------------------------
# probs finalizer: one canonical computation for the inclusion probability
# ---------------------------------------------------------------------------

def multisketch_finalize(sk: MultiSketch, *,
                         spec: MultiSketchSpec) -> MultiSketch:
    """Recompute p^(F) from the compacted slab at the fixed shape [c], so
    slabs with equal retained state are bit-equal in all 8 fields whatever
    fold produced them.

    Per-objective membership is the selection's own test, ``seed <= kth``,
    with kth_f the k_f-th smallest f-seed in the slab (every member of
    S^(f) is retained, and every other retained key has an f-seed >= tau_f,
    so this is the kth of the selection). Without ties it equals the
    reference's ``seed < tau``. With a tie at the boundary (kth == tau,
    which the 24-bit u makes likely once a stream holds millions of keys)
    the reference's strict test drops the tied members and leaves them
    with p = 0, so their HT weight 1/p explodes; this test keeps them."""
    fvals = torch.stack([torch.where(sk.valid, f(sk.weights),
                                     torch.zeros_like(sk.weights))
                         for f, _ in spec.objectives])
    c = sk.seeds.shape[1]
    kk = torch.tensor([[min(k, c) - 1] for _, k in spec.objectives],
                      device=sk.seeds.device)
    kth = torch.sort(sk.seeds, dim=1).values.gather(1, kk)       # [nf, 1]
    member_f = ((sk.seeds <= kth) & torch.isfinite(sk.seeds)
                & sk.member[None, :])
    p_f = torch.where(member_f,
                      conditional_prob(fvals, sk.taus[:, None], spec.scheme),
                      torch.zeros_like(fvals))
    return sk._replace(probs=torch.where(sk.member, p_f.amax(dim=0),
                                         torch.zeros_like(sk.weights)))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _build_body(spec, keys, weights, active, use_kernels, seed=None):
    n = keys.shape[0]
    npad = max(n, spec.kmax + 2)  # selection needs a (kmax+1)-th candidate
    if npad > n:
        keys = torch.nn.functional.pad(keys, (0, npad - n), value=-1)
        weights = torch.nn.functional.pad(weights, (0, npad - n))
        active = torch.nn.functional.pad(active, (0, npad - n))
    member, prob, aux, seeds, taus = multisketch_select(
        spec, keys, weights, active, use_kernels=use_kernels, seed=seed)
    return _compact(spec, keys, weights, member, prob, aux, seeds, taus,
                    use_kernels)


def multisketch_build(spec: MultiSketchSpec, keys, weights, active=None,
                      use_kernels: Optional[bool] = None, seed=None,
                      device=None) -> MultiSketch:
    """One-shot S^(F) ∪ Z over a batch, compacted to the wire format.

    Keys are assumed distinct; duplicates in ONE batch are sampled as
    distinct observations (absorb/merge dedup by max weight). ``seed``
    overrides spec.seed at run time and always takes the plain selection
    path, as in the reference. ``device``: where host inputs go (default:
    the inputs' device, else the card).
    """
    dev = device_of(keys, device)
    keys = as_1d(keys, torch.int32, dev)
    weights = as_1d(weights, torch.float32, dev)
    active = (torch.ones(keys.shape, dtype=torch.bool, device=dev)
              if active is None else as_1d(active, torch.bool, dev))
    if seed is not None:
        return multisketch_finalize(
            _build_body(spec, keys, weights, active, False, seed=int(seed)),
            spec=spec)
    return multisketch_finalize(
        _build_body(spec, keys, weights, active,
                    True if use_kernels is None else use_kernels),
        spec=spec)


def multisketch_absorb_inline(spec: MultiSketchSpec, state: MultiSketch,
                              keys, weights, active=None,
                              use_kernels: bool = False) -> MultiSketch:
    """Fold body without the probs finalize: state ∪ chunk."""
    dev = state.keys.device
    keys = as_1d(keys, torch.int32, dev)
    weights = as_1d(weights, torch.float32, dev)
    active = (torch.ones(keys.shape, dtype=torch.bool, device=dev)
              if active is None else as_1d(active, torch.bool, dev))
    return _rebuild(spec, torch.cat([state.keys, keys]),
                    torch.cat([state.weights, weights]),
                    torch.cat([state.valid, active]), use_kernels)


def multisketch_absorb(state: MultiSketch, keys, weights, active=None, *,
                       spec: MultiSketchSpec,
                       use_kernels: Optional[bool] = None) -> MultiSketch:
    """Streaming fold: -> a new slab for state ∪ chunk (``state`` stays
    valid)."""
    return multisketch_finalize(multisketch_absorb_inline(
        spec, state, keys, weights, active,
        True if use_kernels is None else use_kernels), spec=spec)


def delta_slab_pad(keys, weights, valid, cap: int, m_quantum: int = 1):
    """Pad a flattened delta (m slabs x cap slots) with inert slots (key -1,
    weight 0, invalid) to the next power-of-two multiple of ``m_quantum``
    slabs (the reference's shape bucketing; the retained bits do not
    depend on it)."""
    m = -(-keys.shape[0] // cap)
    mq = max(m_quantum, 1)
    while mq < m:
        mq *= 2
    pad = mq * cap - keys.shape[0]
    if pad:
        keys = torch.nn.functional.pad(keys, (0, pad), value=-1)
        weights = torch.nn.functional.pad(weights, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return keys, weights, valid


def multisketch_absorb_into(state: MultiSketch, delta: MultiSketch, *,
                            spec: MultiSketchSpec,
                            use_kernels: Optional[bool] = None,
                            pad_deltas: bool = True) -> MultiSketch:
    """Incremental merge: state ∪ delta, where ``delta`` is one sketch or a
    stacked batch ([m, c] leaves) of sketches under the same spec."""
    return multisketch_absorb_slabs(state, delta.keys, delta.weights,
                                    delta.valid, spec=spec,
                                    use_kernels=use_kernels,
                                    pad_deltas=pad_deltas)


def multisketch_absorb_slabs(state: MultiSketch, delta_keys, delta_weights,
                             delta_valid, *, spec: MultiSketchSpec,
                             use_kernels: Optional[bool] = None,
                             pad_deltas: bool = True) -> MultiSketch:
    """``multisketch_absorb_into`` taking the delta's three consumed leaves
    ([c] or [m, c]) directly."""
    dev = state.keys.device
    dk = as_1d(delta_keys, torch.int32, dev)
    dw = as_1d(delta_weights, torch.float32, dev)
    dv = as_1d(delta_valid, torch.bool, dev)
    if pad_deltas and dk.shape[0] != spec.cap:
        dk, dw, dv = delta_slab_pad(dk, dw, dv, spec.cap)
    return multisketch_finalize(
        _rebuild(spec, torch.cat([state.keys, dk]),
                 torch.cat([state.weights, dw]),
                 torch.cat([state.valid, dv]),
                 True if use_kernels is None else use_kernels), spec=spec)


def multisketch_merge(spec: MultiSketchSpec, a: MultiSketch, b: MultiSketch,
                      use_kernels: Optional[bool] = None) -> MultiSketch:
    """Exact merge of two sketches built under the same spec."""
    return multisketch_finalize(_rebuild(
        spec, torch.cat([a.keys, b.keys]), torch.cat([a.weights, b.weights]),
        torch.cat([a.valid, b.valid]),
        True if use_kernels is None else use_kernels), spec=spec)


def multisketch_merge_stacked(spec: MultiSketchSpec, stacked: MultiSketch,
                              use_kernels: bool = False) -> MultiSketch:
    """Merge a stacked batch of sketches (leaves [m, ...]) in ONE
    re-selection."""
    return multisketch_finalize(
        _rebuild(spec, stacked.keys.reshape(-1),
                 stacked.weights.reshape(-1), stacked.valid.reshape(-1),
                 use_kernels), spec=spec)


def pad_chunk(keys, weights, active=None, chunk: int = 256):
    """Pad a host chunk to the ``chunk`` quantum (keys -1, weights 0,
    inactive). ``active`` defaults to weights > 0."""
    keys = np.asarray(keys, np.int32).reshape(-1)
    weights = np.asarray(weights, np.float32).reshape(-1)
    active = (weights > 0 if active is None
              else np.asarray(active, bool).reshape(-1))
    n = keys.shape[0]
    npad = max(chunk, -(-n // chunk) * chunk)
    if npad > n:
        keys = np.pad(keys, (0, npad - n), constant_values=-1)
        weights = np.pad(weights, (0, npad - n))
        active = np.pad(active, (0, npad - n))
    return keys, weights, active


def quarantine_chunk(keys, weights, active=None):
    """Per-row input quarantine: a NaN/inf/negative weight or a NaN/inf/
    negative/out-of-int32 key marks its row inactive (weight 0, key -1),
    exactly like ``pad_chunk`` padding. Returns ``(keys int32, weights
    float32, active bool, n_quarantined)``."""
    kf = np.asarray(keys).reshape(-1).astype(np.float64)
    wf = np.asarray(weights).reshape(-1).astype(np.float64)
    act = (np.ones(kf.shape, bool) if active is None
           else np.asarray(active, bool).reshape(-1))
    bad_w = ~np.isfinite(wf) | (wf < 0.0)
    bad_k = (~np.isfinite(kf) | (kf < 0.0)
             | (kf > float(np.iinfo(np.int32).max)))
    bad = bad_w | bad_k
    n_quarantined = int(np.count_nonzero(bad & act))
    out_k = np.where(bad, -1.0, kf).astype(np.int32)
    out_w = np.where(bad, 0.0, wf).astype(np.float32)
    return out_k, out_w, act & ~bad, n_quarantined


def statfn_to_meta(f: StatFn) -> dict:
    """JSON-able encoding of a StatFn (combo recurses)."""
    d = {"kind": f.kind, "param": float(f.param)}
    if f.kind == "combo":
        d["terms"] = [[float(c), statfn_to_meta(g)] for c, g in f.terms]
    return d


def statfn_from_meta(d: dict) -> StatFn:
    terms = tuple((float(c), statfn_from_meta(g))
                  for c, g in d.get("terms", []))
    return StatFn(d["kind"], float(d.get("param", 0.0)), terms)


def spec_to_meta(spec: MultiSketchSpec) -> dict:
    """JSON-able encoding of a spec (the checkpoint's static half; the same
    encoding as the reference, so either package reads the other's)."""
    return {"objectives": [[statfn_to_meta(f), int(k)]
                           for f, k in spec.objectives],
            "scheme": spec.scheme, "seed": int(spec.seed),
            "capacity": int(spec.capacity)}


def spec_from_meta(d: dict) -> MultiSketchSpec:
    return MultiSketchSpec(
        objectives=tuple((statfn_from_meta(f), int(k))
                         for f, k in d["objectives"]),
        scheme=d["scheme"], seed=int(d["seed"]),
        capacity=int(d.get("capacity", 0)))


def multisketch_overflow(sk: MultiSketch) -> torch.Tensor:
    """True iff the slab is full, i.e. compaction MAY have truncated S ∪ Z
    (a device scalar; read it with ``bool()``)."""
    return torch.all(sk.valid)


def multisketch_estimate(sk: MultiSketch, f: StatFn,
                         segment_fn=None) -> torch.Tensor:
    """HT estimate of Q(f, H) from the slab (paper Eq. 5: inverse p^(F)
    weighting). ``segment_fn``: vectorized key predicate for H."""
    from .merge import sketch_estimate
    return sketch_estimate(sk, f, segment_fn)


def multisketch_estimate_batch(sk: MultiSketch, fs, predicates,
                               use_kernels: Optional[bool] = None
                               ) -> torch.Tensor:
    """Batched HT estimates Q(f_i, H_b) -> float32 [|F|, B] from one slab
    pass: K4 when every f has a kernel encoding (and ``use_kernels``),
    else the plain contribution-times-selection reduction."""
    fs = tuple(fs)
    table = torch.from_numpy(np.ascontiguousarray(
        encode_predicates(predicates))).to(sk.keys.device)
    uk = True if use_kernels is None else use_kernels
    if uk and all(f.kind in _KERNEL_KIND for f in fs):
        enc = tuple((_KERNEL_KIND[f.kind], float(f.param)) for f in fs)
        from repro_torch.kernels.segquery import segment_query_slab
        return segment_query_slab(sk.keys, sk.weights, sk.probs, sk.member,
                                  table, enc)
    return estimate_many(fs, sk.weights, sk.probs, sk.member,
                         predicate_matrix(sk.keys, table))


def multisketch_query_many(sk: MultiSketch, fs, predicates,
                           b_quantum: int = 16,
                           use_kernels: Optional[bool] = None) -> np.ndarray:
    """Host-facing batched query: encode predicates, pad B up to a
    ``b_quantum`` bucket with never-matching rows (B == 1 runs unpadded),
    estimate, slice back. Returns float32 numpy [|F|, B]."""
    table = encode_predicates(predicates)
    b = table.shape[0]
    bpad = 1 if b == 1 else max(b_quantum, -(-b // b_quantum) * b_quantum)
    out = multisketch_estimate_batch(sk, tuple(fs), pad_table(table, bpad),
                                     use_kernels=use_kernels)
    return out.cpu().numpy()[:, :b]
