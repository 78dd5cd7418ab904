#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

0. the card's name and power limit (nvidia-smi), then the nvcc build of the
   six CUDA kernels from ``src/repro_torch/kernels/csrc``;
1. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (K1-K4: the 8-objective smoke spec, k = 1024 each,
   capacity 8201; K5: c = 4098 slab points of dim 68 against (Q, Cmax) in
   {(1, 20), (128, 20), (128, 1)}, and dim 3, in cost mode at mu in
   {1, 2, 1.5} and in ball mode, run-to-run and alone-vs-batch bits; K6:
   exact at n = 65,536 and on 4,096 sampled rows at n = 2^20), with the
   kernel's, the plain version's and, where one exists, a single PyTorch
   call's time (CUDA events, median of 21; K6 of 5; K5 also at Q = 16),
   and the registers, local (spill) bytes and static shared memory of K4
   and K5 from ``cudaFuncGetAttributes`` with their launch plans;
2. serving through ``EnginePool``: 3 tenants x 4 shards, 16 chunks of
   1,048,576 rows each, interleaved with 32 submitted query batches
   (B = 128, all 8 objectives) per tenant; every response FRESH, the
   whole-stream sum/count estimates within 4 cv of the exact values, a
   plain-path twin engine bit-equal, the last round's pumped answers
   bit-equal to direct queries, and one absorb / one query moving the
   kernel launch counters by exactly (2, 4, 2, 0, 0, 0) /
   (0, 0, 0, 1, 0, 0);
3. durability: snapshot + WAL tail, close, ``EnginePool.open``, answers
   bit-identical;
4. the metric tier at the shape of US Census Data (1990), 2,458,285 points
   x 68 attributes (a 20-component Gaussian mixture made on the card from a
   fixed seed): ``ClusterEngine(k=4096, mu=2, 8 anchors)`` absorbs it in 10
   chunks, ``local_search(k=20, n_cand=32, rounds=16)`` and
   ``kcenter(20)`` run on it; a plain-path twin engine gives a bit-equal
   slab and service costs within rtol 1e-5, one absorb / one service_costs
   move the counters by exactly (1, 2, 1, 0, 0, 0) / (0, 0, 0, 0, 1, 0),
   the estimated costs of the generator's centers and of the search's
   initial set lie within 4 cv of their exact costs over all points, the
   search does not raise the exact cost, and k-center's coverage equals
   its total;
5. the universal tier, ``examples/quickstart.py`` at 2^20 keys (weights
   lognormal(0, 2) made on the card, hash seed 42, k = 64): one universal
   monotone sample (size within the Thm 5.1 expectation plus 4 sigma;
   COUNT, SUM, thresh(5), cap(2), moment(1.5) on the segment domain == 3
   within 4 cv of exact), 16 shard sketches folded with ``merge_sketches``
   equal to the whole-set sketch (member triples) with its SUM within
   4 cv, ``ops.multi_objective_bottomk_kernel`` (K1 + K2) equal to
   ``multi_bottomk_sample`` (members exact, probs within 1e-6), and on
   weights clip(lognormal(0, 1), 0.1, 10) ``universal_capping_sample``
   (k = 64, m_cap = 4096) against ``ops.universal_capping_kernel`` (K6 at
   2^20): members and hl equal, size within Thm 6.1's bound, cap_T
   estimates within 4 cv for T in {0.5, 1, 2, 5}; then a warm sample and
   a shard fold under the profiler (wall, device time, idle share).

Prints the card line, a ``{"kernels": [...]}`` line (launch counts of K1-K4
from phase 2, of K5 from phase 4 and of K6 from phase 5, errors and times
from phase 1; K6's row gives its time at n = 2^20 and its plain version's
at ``plain_n`` = 65,536, beside the kernel's own time there) and, last,
``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CHUNK = 1 << 20                 # rows per absorbed chunk
N_CHUNKS = 16                   # chunks per tenant
SHARDS = 4
B = 128                         # predicates per query batch
QUERIES_PER_TENANT = 32
CENSUS_N = 2_458_285            # US Census Data (1990), UCI: points
CENSUS_DIM = 68                 # ... and attributes
CENSUS_COMPONENTS = 20          # mixture components = centers sought
CENSUS_CHUNKS = 10
SLAB_K = 4096                   # ClusterEngine(k=...): capacity 4098
LS_CAND = 32
LS_ROUNDS = 16
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
REPS = 21
K6_SMALL = 65_536               # K6 kernel = plain on all rows
K6_ROWS = 4096                  # ... and on this many rows at 2^20
UNIVERSAL_N = 1 << 20           # keys of the universal tier (phase 5)
UNIVERSAL_K = 64
UNIVERSAL_SHARDS = 16
CAPPING_M_CAP = 4096
SERVING_KERNELS = ("seeds", "blockselect", "compact", "segquery")


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond, msg: str):
    if not cond:
        _fail(msg)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int = REPS, inner: int = 5) -> float:
    """Median device time of ``fn`` in ms. A sleep kernel holds the stream
    while the host enqueues ``inner`` calls, so the events bracket
    back-to-back device work and no host launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and fp32-
    rate operations over the fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulps(a, b):
    """Per-element ulp distance of two float32 tensors (+inf must match)."""
    import torch
    _check(torch.equal(torch.isinf(a), torch.isinf(b)), "inf pattern differs")
    fin = torch.isfinite(a)
    ai = a[fin].view(torch.int32).to(torch.int64)
    bi = b[fin].view(torch.int32).to(torch.int64)
    return int((ai - bi).abs().max().item()) if ai.numel() else 0


def max_abs(a, b) -> float:
    import torch
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max().item()) if fin.any() else 0.0


def smoke_spec(C, scheme: str):
    objs = (C.SUM, C.COUNT, C.thresh(2.0), C.cap(1.5), C.moment(1.5),
            C.thresh(0.5), C.cap(4.0), C.moment(0.5))
    return C.MultiSketchSpec(objectives=tuple((f, 1024) for f in objs),
                             scheme=scheme, seed=17)


def predicate_table(C, rng, key_hi: int):
    """B predicates: EVERYTHING first, then key ranges, key masks and
    hash fractions in turn."""
    preds = [C.EVERYTHING]
    while len(preds) < B:
        r = len(preds) % 3
        if r == 0:
            lo = int(rng.integers(0, key_hi))
            preds.append(C.key_range(lo, int(rng.integers(lo, key_hi))))
        elif r == 1:
            preds.append(C.key_mask(7, int(rng.integers(0, 8))))
        else:
            preds.append(C.hash_fraction(float(rng.uniform(0.05, 0.9)),
                                         int(rng.integers(0, 1000))))
    return C.encode_predicates(preds)


def tenant_chunk(t: int, c: int, rng):
    """Chunk c of tenant t: distinct keys (i * 2654435761) mod 2^31 over
    the tenant's own range of i, lognormal(0, 1.5) weights."""
    i = (np.arange(CHUNK, dtype=np.int64) + t * (1 << 25) + c * CHUNK)
    keys = ((i * 2654435761) % (1 << 31)).astype(np.int32)
    w = rng.lognormal(0.0, 1.5, CHUNK).astype(np.float32)
    return keys, w


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(torch, C, K, dev):
    from repro_torch.kernels.blockselect import (
        batched_bottomk_select_plain, block_candidates_plain)
    from repro_torch.kernels.compact import (compact_take_plain,
                                             retention_priority_plain)
    from repro_torch.kernels.seeds import fused_seeds_fvals_plain
    from repro_torch.kernels.segquery import segment_query_slab_plain

    rng = np.random.default_rng(1)
    spec = smoke_spec(C, "ppswor")
    enc = spec.kernel_objectives()
    cap = spec.cap
    n = CHUNK + cap                            # one chunk plus one slab
    keys = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, n).astype(
        np.int32)).to(dev)
    w = torch.from_numpy(rng.lognormal(0, 1.5, n).astype(np.float32)).to(dev)
    act = torch.from_numpy(rng.random(n) < 0.99).to(dev)
    out = {}

    # K1 ------------------------------------------------------------------
    exact_rows = [j for j, (kind, _) in enumerate(enc) if kind != 4]
    moment_rows = [j for j, (kind, _) in enumerate(enc) if kind == 4]
    err = 0.0
    for scheme in ("ppswor", "priority"):
        sk, fk = K.fused_seeds_fvals(keys, w, act, enc, scheme, 17)
        sp, fp = fused_seeds_fvals_plain(keys, w, act, enc, scheme, 17)
        torch.cuda.synchronize()
        _check(torch.equal(fk[exact_rows], fp[exact_rows]),
               f"K1 {scheme}: fvals differ for sum/count/thresh/cap")
        _check(ulps(fk[moment_rows], fp[moment_rows]) <= 2,
               f"K1 {scheme}: moment fvals beyond 2 ulp")
        _check(ulps(sk, sp) <= 2, f"K1 {scheme}: seeds beyond 2 ulp")
        if scheme == "priority":
            _check(torch.equal(sk[exact_rows], sp[exact_rows]),
                   "K1 priority: seeds differ for sum/count/thresh/cap")
        err = max(err, max_abs(sk, sp), max_abs(fk, fp))
    nf = len(enc)
    t_k = cuda_ms(torch, lambda: K.fused_seeds_fvals(keys, w, act, enc,
                                                     "ppswor", 17))
    t_p = cuda_ms(torch, lambda: fused_seeds_fvals_plain(keys, w, act, enc,
                                                         "ppswor", 17))
    # bytes: key, weight, active read once; F seeds + F f-values written.
    # ops: per row hash->u->r (~30) plus per objective f(w), test, divide.
    b_ms, b_by = bound(n * 9 + 2 * nf * n * 4, n * (30 + 4 * nf))
    out["seeds"] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"K1 seeds n={n} F={nf}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms,"
          f" bound {b_ms:.4f} ms ({b_by}); exact/<=2ulp checks passed",
          flush=True)

    # K2 ------------------------------------------------------------------
    seeds, _ = K.fused_seeds_fvals(keys, w, act, enc, "ppswor", 17)
    err = 0.0
    for k in (1025, cap + 1):
        vk, ik, tk = K.batched_bottomk_select(seeds, k)
        vp, ip, tp = batched_bottomk_select_plain(seeds, k)
        torch.cuda.synchronize()
        _check(torch.equal(vk, vp) and torch.equal(ik, ip)
               and torch.equal(tk, tp), f"K2 k={k}: vals/idx/tau differ")
        ck = K.blockselect.block_candidates(seeds, min(k + 1, n))
        cp = block_candidates_plain(seeds, min(k + 1, n))
        _check(torch.equal(ck[0], cp[0]) and torch.equal(ck[1], cp[1]),
               f"K2 k={k}: block candidates differ")
        err = max(err, max_abs(vk, vp))
    times = {}
    nb = -(-n // 2048)
    for k in (1025, cap + 1):
        ksel = min(k + 1, n)
        kb = min(ksel, 2048)
        padded = torch.nn.functional.pad(seeds, (0, nb * 2048 - n),
                                         value=float("inf"))
        t_k = cuda_ms(torch, lambda: K.blockselect.block_candidates(
            seeds, ksel))
        t_p = cuda_ms(torch, lambda: block_candidates_plain(seeds, ksel))
        t_l = cuda_ms(torch, lambda: torch.sort(
            padded.view(nf, nb, 2048), dim=-1, stable=True))
        # bytes: every seed read once, nb * kb (value, index) pairs written;
        # ops: one comparison per seed at least
        b_ms, b_by = bound(nf * n * 4 + nf * nb * kb * 8, nf * n)
        times[k] = (t_k, t_p, t_l, b_ms, b_by)
        print(f"K2 blockselect [{nf},{n}] k={k} (kb={kb}): kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, torch.sort {t_l:.4f} ms,"
              f" bound {b_ms:.4f} ms ({b_by}); exact", flush=True)
    t_k, t_p, t_l, b_ms, b_by = times[1025]
    out["blockselect"] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                              bound_ms=b_ms, bound_by=b_by, library_ms=t_l)

    # K3 ------------------------------------------------------------------
    sorted_keys = torch.sort(keys).values
    member = torch.from_numpy(rng.random(n) < cap / n).to(dev)
    keep = member | torch.from_numpy(rng.random(n) < 8 / n).to(dev)
    pk = K.retention_priority(sorted_keys, w, member, keep)
    pp = retention_priority_plain(sorted_keys, w, member, keep)
    tk_, vk_ = K.compact_take(sorted_keys, w, member, keep, cap)
    tp_, vp_ = compact_take_plain(sorted_keys, w, member, keep, cap)
    torch.cuda.synchronize()
    _check(torch.equal(pk, pp), "K3: priorities differ")
    _check(torch.equal(tk_, tp_) and torch.equal(vk_, vp_),
           "K3: compact_take differs")
    t_k = cuda_ms(torch, lambda: K.retention_priority(sorted_keys, w,
                                                      member, keep))
    t_p = cuda_ms(torch, lambda: retention_priority_plain(sorted_keys, w,
                                                          member, keep))
    # bytes: key, weight, member, keep read once, priority written; ops:
    # dedup compare, 1/(1+w), select (~6 per row)
    b_ms, b_by = bound(n * (4 + 4 + 1 + 1) + n * 4, 6 * n)
    out["compact"] = dict(max_abs_err=max_abs(pk, pp), ms=t_k, plain_ms=t_p,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"K3 compact n={n}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}); priorities and take exact",
          flush=True)

    # K4 ------------------------------------------------------------------
    # pump coalesces a tenant's requests into one table: phase 2 sends two
    # of B = 128 per tenant per round, so the main path launches B = 2 * 128
    slab = C.multisketch_build(spec, keys[:CHUNK], w[:CHUNK], act[:CHUNK])
    c = slab.keys.shape[0]
    table = torch.from_numpy(predicate_table(C, rng, 2 ** 31 - 1)).to(dev)
    stacked = torch.cat([table, torch.from_numpy(
        predicate_table(C, rng, 2 ** 31 - 1)).to(dev)])
    nb_main = stacked.shape[0]
    args = (slab.keys, slab.weights, slab.probs, slab.member)
    err = 0.0
    for b in (1, 16, B, nb_main):
        qk = K.segment_query_slab(*args, stacked[:b], enc)
        qp = segment_query_slab_plain(*args, stacked[:b], enc)
        q2 = K.segment_query_slab(*args, stacked[:b], enc)
        torch.cuda.synchronize()
        _check(torch.equal(qk, q2), f"K4 B={b}: not run-to-run identical")
        _check(torch.allclose(qk, qp, rtol=1e-5, atol=0.0),
               f"K4 B={b}: beyond rtol 1e-5 of the plain version")
        err = max(err, max_abs(qk, qp))
    full = K.segment_query_slab(*args, stacked, enc)
    for i in (0, 1, 2, 3, 77, B, B + 1, B + 77, nb_main - 1):
        alone = K.segment_query_slab(*args, stacked[i:i + 1].contiguous(),
                                     enc)
        _check(torch.equal(alone[:, 0], full[:, i]),
               f"K4: predicate {i} alone differs from its batch-of-"
               f"{nb_main} bits")
    for half in (0, B):
        own = K.segment_query_slab(*args, stacked[half:half + B], enc)
        _check(torch.equal(own, full[:, half:half + B]),
               f"K4: request at column {half} differs from its bits in the "
               f"coalesced batch of {nb_main}")
    ht = torch.where(slab.member, 1.0 / torch.clamp_min(slab.probs, 1e-30),
                     torch.zeros_like(slab.probs))
    contrib = torch.stack([f(slab.weights) for f, _ in spec.objectives]) * ht
    sel_t = C.predicate_matrix(slab.keys, stacked).to(torch.float32).T
    sel_t = sel_t.contiguous()
    t_k = cuda_ms(torch, lambda: K.segment_query_slab(*args, stacked, enc))
    t_p = cuda_ms(torch, lambda: segment_query_slab_plain(*args, stacked,
                                                          enc))
    t_l = cuda_ms(torch, lambda: torch.matmul(contrib, sel_t))
    n_hash = int((stacked[:, 5] & 1).sum().item())
    # bytes: slab fields read once, table read, answers written; ops: per
    # (slot, predicate) the range/mask test (6) and F adds, per (slot, hash
    # predicate) two fmix32 rounds (18), per slot F f(w) * ht (2F)
    b_ms, b_by = bound(c * 13 + nb_main * 6 * 4 + nf * nb_main * 4,
                       c * nb_main * (6 + nf) + c * n_hash * 18
                       + c * 2 * nf)
    out["segquery"] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                           bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
    print(f"K4 segquery c={c} F={nf} B={nb_main} (two coalesced requests "
          f"of {B}): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, torch.matmul "
          f"{t_l:.4f} ms, bound {b_ms:.5f} ms ({b_by}); rtol 1e-5 at B in "
          f"(1, 16, {B}, {nb_main}), run-to-run and batch-independent bits",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 2: serving through EnginePool
# ---------------------------------------------------------------------------

def phase_serving(torch, C, K, pool_mod, query_mod):
    from repro_torch.launch.pool import EnginePool
    SegmentQueryEngine = query_mod.SegmentQueryEngine
    tenants = {"t0": "ppswor", "t1": "ppswor", "t2": "priority"}
    rng_q = np.random.default_rng(5)
    tables = {t: predicate_table(C, rng_q, 2 ** 31 - 1) for t in tenants}
    pool = EnginePool(sleep=lambda s: None)
    specs = {t: smoke_spec(C, s) for t, s in tenants.items()}
    for t, spec in specs.items():
        pool.create_stream(t, spec, shards=SHARDS)
    rngs = {t: np.random.default_rng(100 + i) for i, t in enumerate(tenants)}
    exact = {t: [0.0, 0] for t in tenants}    # float64 sum, count
    twin_chunks = []
    absorb_ms, pump_ms = [], []
    futures = []
    per_round = QUERIES_PER_TENANT // N_CHUNKS
    K.reset_launch_counts()
    for c in range(N_CHUNKS):
        for t in tenants:
            keys, w = tenant_chunk(t_index(t), c, rngs[t])
            if t == "t0":
                twin_chunks.append((keys, w, c % SHARDS))
            t0 = time.perf_counter()
            r = pool.absorb(t, keys, w, shard=c % SHARDS)
            absorb_ms.append((time.perf_counter() - t0) * 1e3)
            _check(r.applied and r.accepted == CHUNK and r.quarantined == 0,
                   f"absorb {t}/{c} not applied: {r}")
            exact[t][0] += float(np.sum(w, dtype=np.float64))
            exact[t][1] += CHUNK
        round_futs = []
        for t in tenants:
            for _ in range(per_round):
                round_futs.append((t, tuple(exact[t]),
                                   pool.submit(t, predicates=tables[t])))
        t0 = time.perf_counter()
        pool.pump()
        pump_ms.append((time.perf_counter() - t0) * 1e3)
        futures += round_futs
    counts = K.launch_counts()
    for name in SERVING_KERNELS:
        _check(counts[name] > 0,
               f"kernel {name} never launched on the serving path")
    cvb = C.cv_bound(1.0, 1024)
    for t, (s_exact, n_exact), fut in futures:
        r = fut.result(0)
        _check(r.status == pool_mod.FRESH and r.epoch_lag == 0,
               f"{t}: response {r.status} lag {r.epoch_lag}")
        _check(r.values.shape == (8, B) and np.isfinite(r.values).all(),
               f"{t}: bad response values")
        for j, ex in ((0, s_exact), (1, float(n_exact))):
            _check(abs(float(r.values[j, 0]) - ex) <= 4 * cvb * ex,
                   f"{t}: objective {j} EVERYTHING estimate "
                   f"{r.values[j, 0]} vs exact {ex} beyond 4 cv")
    print(f"serving: {len(futures)} responses FRESH, EVERYTHING sum/count "
          f"within 4 cv ({4 * cvb:.4f}) of exact; absorb ms p50 "
          f"{np.percentile(absorb_ms, 50):.3f} p95 "
          f"{np.percentile(absorb_ms, 95):.3f}; query-batch (pump, "
          f"{len(tenants)} tenants x {per_round} x B={B}) ms p50 "
          f"{np.percentile(pump_ms, 50):.3f} p95 "
          f"{np.percentile(pump_ms, 95):.3f}", flush=True)

    # plain-path twin of tenant t0 on the card
    eng = pool._stream("t0").engine
    twin = SegmentQueryEngine(specs["t0"], shards=SHARDS, use_kernels=False)
    for keys, w, shard in twin_chunks:
        twin.absorb(keys, w, shard=shard)
    a, b = eng.merged, twin.merged
    for name in ("keys", "member", "aux", "valid", "weights", "taus"):
        _check(torch.equal(getattr(a, name), getattr(b, name)),
               f"twin: merged {name} differs")
    _check(ulps(a.seeds, b.seeds) <= 2, "twin: seeds beyond 2 ulp")
    _check(ulps(a.probs, b.probs) <= 4, "twin: probs beyond 4 ulp")
    qa = eng.query_many(predicates=tables["t0"])
    qb = twin.query_many(predicates=tables["t0"])
    _check(np.allclose(qa, qb, rtol=1e-5, atol=0.0),
           "twin: answers beyond rtol 1e-5")
    # the last round's pumped responses, each a slice of one coalesced
    # launch, against the engine asked directly and against the twin
    for t, _, fut in futures[-len(tenants) * per_round:]:
        got = fut.result(0).values
        direct = pool._stream(t).engine.query_many(predicates=tables[t])
        _check(np.array_equal(got, direct),
               f"{t}: pumped answers differ from the direct query's bits")
        if t == "t0":
            _check(np.allclose(got, qb, rtol=1e-5, atol=0.0),
                   "t0: pumped answers beyond rtol 1e-5 of the twin")
    print("twin (use_kernels=False): merged slab equal, answers within "
          "rtol 1e-5; last round's pumped answers (all 8 x B) bit-equal to "
          "direct queries and within rtol 1e-5 of the twin", flush=True)

    # one controlled epoch on the warm engine
    keys, w = tenant_chunk(t_index("t0"), N_CHUNKS, rngs["t0"])
    K.reset_launch_counts()
    pool.absorb("t0", keys, w, shard=0)
    absorb_counts = K.launch_counts()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    eng.query_many(predicates=tables["t0"])
    q_ms = (time.perf_counter() - t0) * 1e3
    query_counts = K.launch_counts()
    want_a = {"seeds": 2, "blockselect": 4, "compact": 2, "segquery": 0,
              "servicecost": 0, "rankcount": 0}
    want_q = {"seeds": 0, "blockselect": 0, "compact": 0, "segquery": 1,
              "servicecost": 0, "rankcount": 0}
    _check(absorb_counts == want_a, f"absorb launches {absorb_counts}")
    _check(query_counts == want_q, f"query launches {query_counts}")
    print(f"controlled epoch: absorb launches {absorb_counts}, query_many "
          f"launches {query_counts} ({q_ms:.3f} ms host)", flush=True)
    absorb_breakdown(torch, C, eng, rngs["t0"])
    pool.close()
    return counts


def absorb_breakdown(torch, C, eng, rng):
    """Where one warm absorb's time goes: host quarantine, then the
    engine's fold + absorb-time upkeep (drained) of that same chunk under
    the profiler: its wall time, the device time of its kernels and
    copies, and its sorts by input shape. A second, unprofiled absorb
    gives the wall time without the profiler's host overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    keys, w = tenant_chunk(t_index("t0"), N_CHUNKS + 1, rng)
    t0 = time.perf_counter()
    k, ww, act, _ = C.quarantine_chunk(keys, w)
    q_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        eng.absorb(k, ww, act, shard=1)
        eng.drain()
        fold_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched
    ops = [(e.key, e.self_device_time_total / 1e3)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    ops.sort(key=lambda x: -x[1])
    dev_ms = sum(t for _, t in ops)
    top = ", ".join(f"{name[:40]} {t:.3f}" for name, t in ops[:8])
    sorts = sorted(((e.input_shapes[0], e.count, e.device_time_total / 1e3)
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.device_type == DeviceType.CPU
                    and e.key == "aten::sort"), key=lambda x: -x[2])
    by_shape = ", ".join(f"{shape} x{n} {t:.3f}" for shape, n, t in sorts)
    keys, w = tenant_chunk(t_index("t0"), N_CHUNKS + 2, rng)
    k, ww, act, _ = C.quarantine_chunk(keys, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.absorb(k, ww, act, shard=2)
    eng.drain()
    plain_fold_ms = (time.perf_counter() - t0) * 1e3
    print(f"absorb breakdown: quarantine {q_ms:.3f} ms host; the same "
          f"chunk's engine fold + upkeep under the profiler {fold_ms:.3f} ms "
          f"wall (drained), device time {dev_ms:.3f} ms (idle share "
          f"{max(0.0, 1 - dev_ms / fold_ms):.3f}, profiler host overhead "
          f"included in the wall); top device ops ms: {top}; aten::sort by "
          f"input shape (count, device ms): {by_shape}; another chunk's "
          f"fold + upkeep without the profiler {plain_fold_ms:.3f} ms wall",
          flush=True)


def t_index(t: str) -> int:
    return int(t[1:])


# ---------------------------------------------------------------------------
# phase 3: durability
# ---------------------------------------------------------------------------

def phase_durability(C, pool_mod):
    EnginePool = pool_mod.EnginePool
    spec = smoke_spec(C, "ppswor")
    table = predicate_table(C, np.random.default_rng(7), 2 ** 31 - 1)
    rng = np.random.default_rng(300)
    with tempfile.TemporaryDirectory() as d:
        pool = EnginePool(durability_dir=d, sleep=lambda s: None)
        pool.create_stream("d0", spec, shards=SHARDS)
        for c in range(4):
            keys, w = tenant_chunk(3, c, rng)
            pool.absorb("d0", keys, w, shard=c % SHARDS)
            if c == 1:
                pool.snapshot("d0")        # chunks 2, 3 stay in the WAL tail
        before = pool.query("d0", predicates=table)
        pool.close()
        reopened = EnginePool.open(d, sleep=lambda s: None)
        after = reopened.query("d0", predicates=table)
        reopened.close()
    _check(before.status == after.status == pool_mod.FRESH,
           "durability: responses not FRESH")
    _check(np.array_equal(before.values, after.values),
           "durability: answers after EnginePool.open differ")
    print("durability: snapshot + WAL tail recovered, answers bit-identical",
          flush=True)


# ---------------------------------------------------------------------------
# phase 1, K5: the service-cost kernel against its plain version
# ---------------------------------------------------------------------------

def k5_inputs(torch, CO, dev, q, cmax, dim, c, mode, rng):
    """A slab of c points (the census mixture's scale) and a [q, cmax]
    table of ragged sets near the data with one all-invalid row; ``mode``:
    a cost-mode mu (1.0, 2.0, 1.5) for every row, or "ball"."""
    pts = rng.normal(0, 7.9, (c, dim)).astype(np.float32)
    centers = (pts[rng.integers(0, c, (q, cmax))]
               + rng.normal(0, 2.5, (q, cmax, dim))).astype(np.float32)
    cvalid = np.arange(cmax)[None, :] < rng.integers(1, cmax + 1, (q, 1))
    if q > 5:
        cvalid[5] = False
    ball = mode == "ball"
    mu = np.full(q, 1.0 if ball else mode, np.float32)
    # radii around the typical nearest-center distance, so balls cut sets
    radius = (np.sqrt(2.0 * dim) * 2.5 * rng.uniform(0.8, 1.2, q)).astype(
        np.float32)
    probs = rng.uniform(0.02, 1.0, c).astype(np.float32)
    member = rng.random(c) < 0.8
    slab = tuple(torch.from_numpy(a).to(dev) for a in (pts, probs, member))
    table = CO.table_to(CO.CostTable(centers, cvalid, mu, radius, np.full(
        q, int(ball), np.int32)), dev)
    return slab, table


def k5_check(torch, CO, got, want, slab, table, what):
    """Cost rows within rtol 1e-5 of the plain version; a ball row within
    that rtol plus the HT weight of exactly the slots whose plain d2 lies
    within 8 eps32 (|x|^2 + |c|^2) of r^2. Returns the largest error."""
    pts, probs, member = slab
    ht = torch.where(member, 1.0 / torch.clamp_min(probs, 1e-30),
                     torch.zeros_like(probs)).double()
    pn2 = (pts.double() ** 2).sum(1)
    err = 0.0
    for i in range(got.shape[0]):
        g, w = float(got[i]), float(want[i])
        slack = 1e-5 * abs(w)
        if int(table.mode[i]) == CO.MODE_BALL and bool(table.cvalid[i].any()):
            ctr = table.centers[i][table.cvalid[i]]
            d2 = CO.sq_dists(ctr, pts).double()
            tol = 8 * 2.0 ** -23 * ((ctr.double() ** 2).sum(1)[:, None]
                                    + pn2[None, :])
            near = ((d2.min(0).values - float(table.param[i]) ** 2).abs()
                    <= tol.max(0).values)
            slack += float(ht[near].sum())
        _check(abs(g - w) <= slack,
               f"K5 {what} row {i}: kernel {g} vs plain {w} (allowed "
               f"{slack})")
        err = max(err, abs(g - w))
    return err


def phase_k5(torch, K, dev):
    from repro_torch.core import costs as CO
    from repro_torch.kernels.servicecost import service_cost_slab_plain
    rng = np.random.default_rng(11)
    c = SLAB_K + 2                              # the engine's capacity
    err = 0.0
    for q, cmax, dim in ((1, 20, CENSUS_DIM), (128, 20, CENSUS_DIM),
                         (128, 1, CENSUS_DIM), (128, 20, 3)):
        for mode in (1.0, 2.0, 1.5, "ball"):
            slab, table = k5_inputs(torch, CO, dev, q, cmax, dim, c, mode,
                                    rng)
            got = K.service_cost_slab(*slab, table)
            again = K.service_cost_slab(*slab, table)
            want = service_cost_slab_plain(*slab, table)
            torch.cuda.synchronize()
            what = f"Q={q} Cmax={cmax} dim={dim} mode={mode}"
            _check(torch.equal(got, again), f"K5 {what}: not run-to-run "
                   "identical")
            e = k5_check(torch, CO, got, want, slab, table, what)
            if mode != "ball":
                err = max(err, e)
            if q > 5:
                _check(float(got[5]) == 0.0, f"K5 {what}: all-invalid row "
                       "not 0")
                for i in (0, 3, 77, q - 1):
                    alone = CO.CostTable(*(x[i:i + 1].contiguous()
                                           for x in table))
                    _check(torch.equal(K.service_cost_slab(*slab, alone)[0],
                                       got[i]),
                           f"K5 {what}: set {i} alone differs from its bits "
                           f"in the batch of {q}")
        pw = torch.rand(c, device=dev)
        k5_check(torch, CO, K.service_cost_slab(*slab, table,
                                                point_weights=pw),
                 service_cost_slab_plain(*slab, table, pw), slab, table,
                 f"Q={q} dim={dim} weighted")
    # timing at the local-search launch shapes: Q = 128, and the padded
    # Q = 16 of a round's last launch and of single queries
    slab, table = k5_inputs(torch, CO, dev, 16, 20, CENSUS_DIM, c, 2.0, rng)
    t_16 = cuda_ms(torch, lambda: K.service_cost_slab(*slab, table))
    slab, table = k5_inputs(torch, CO, dev, 128, 20, CENSUS_DIM, c, 2.0, rng)
    pts = slab[0]
    flat = table.centers.reshape(-1, CENSUS_DIM)
    pts_t = pts.T.contiguous()
    t_k = cuda_ms(torch, lambda: K.service_cost_slab(*slab, table))
    t_p = cuda_ms(torch, lambda: service_cost_slab_plain(*slab, table))
    t_l = cuda_ms(torch, lambda: torch.matmul(flat, pts_t))
    q, cmax = table.cvalid.shape
    # bytes: points, probs, member read once, centers, cvalid, mu, param,
    # mode read once, Q answers written; ops: 2 dim per (set, center, slot)
    # distance product, plus |x|^2 and |c|^2 (2 dim each)
    b_ms, b_by = bound(c * (CENSUS_DIM * 4 + 5)
                       + q * cmax * (CENSUS_DIM * 4 + 1) + q * 16,
                       2 * q * cmax * CENSUS_DIM * c + 2 * CENSUS_DIM * c
                       + 2 * q * cmax * CENSUS_DIM)
    print(f"K5 servicecost c={c} Q={q} Cmax={cmax} dim={CENSUS_DIM}: kernel "
          f"{t_k:.4f} ms (Q=16: {t_16:.4f} ms), plain {t_p:.4f} ms, "
          f"torch.matmul of the distance "
          f"product alone {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
          f"cost rows rtol 1e-5 and ball rows within the d2 window at "
          f"(Q, Cmax) in (1, 20), (128, 20), (128, 1) and dim 3, mu in "
          f"(1, 2, 1.5) and ball; run-to-run and alone-vs-batch bits",
          flush=True)
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_l, ms_q16=t_16)


def kernel_attributes(K):
    """Print the registers, local (spill) bytes and static shared memory
    of K4 and K5 (``cudaFuncGetAttributes``) and their launch plans at the
    main path's shapes."""
    from repro_torch.kernels import segquery, servicecost
    from repro_torch.kernels._util import kernel_attrs
    c4, c5 = 8201, SLAB_K + 2
    print("kernel attributes: " + "; ".join(
        f"{name} {kernel_attrs(name)}" for name in ("segquery",
                                                     "servicecost"))
        + f"; K4 plan at c={c4} (slices, slice_len) "
        f"{segquery.launch_plan(c4)}; K5 plan at c={c5} dim={CENSUS_DIM} "
        f"{servicecost.launch_plan(c5, CENSUS_DIM, 20)}", flush=True)


# ---------------------------------------------------------------------------
# phase 1, K6: the rank-count kernel against its plain version
# ---------------------------------------------------------------------------

def capping_inputs(torch, C, dev, n: int, seed: int):
    """The operands ``ops.universal_capping_kernel`` hands K6 for n keys
    (ids 0..n-1, hash seed 42) with weights clip(lognormal(0, 1), 0.1, 10)
    made on the card from ``seed``, 5 % of them inactive:
    (weights, u, r/w, active)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(n, generator=g, device=dev).exp().clamp(0.1, 10.0)
    act = torch.rand(n, generator=g, device=dev) >= 0.05
    u = C.uniform01(torch.arange(n, dtype=torch.int32, device=dev), 42)
    rw = torch.where(act, C.rank_of(u, "ppswor") / w,
                     torch.full_like(w, float("inf")))
    return torch.where(act, w, torch.zeros_like(w)), u, rw, act


def phase_k6(torch, C, K, dev, n_small: int = K6_SMALL,
             n_full: int = UNIVERSAL_N):
    from repro_torch.kernels.rankcount import rank_counts_plain
    args = capping_inputs(torch, C, dev, n_small, 6)
    hk_s, lk_s = K.rank_counts(*args)
    hp_s, lp_s = rank_counts_plain(*args)
    torch.cuda.synchronize()
    _check(torch.equal(hk_s, hp_s) and torch.equal(lk_s, lp_s),
           f"K6 n={n_small}: counts differ from the plain version")
    t_small = cuda_ms(torch, lambda: K.rank_counts(*args), reps=5, inner=1)
    t_p = cuda_ms(torch, lambda: rank_counts_plain(*args), reps=5, inner=1)
    big = capping_inputs(torch, C, dev, n_full, 7)
    hk, lk = K.rank_counts(*big)
    rows = torch.randperm(n_full, device=dev)[:K6_ROWS]
    hp, lp = rank_counts_plain(*big, rows=rows)
    torch.cuda.synchronize()
    _check(torch.equal(hk[rows], hp) and torch.equal(lk[rows], lp),
           f"K6 n={n_full}: counts of {K6_ROWS} sampled rows differ from "
           f"the plain version")
    _check(int(hk.max()) > 0 and int(lk.max()) > 0, "K6: all counts zero")
    err = max(max_abs(hk_s, hp_s), max_abs(lk_s, lp_s),
              max_abs(hk[rows], hp), max_abs(lk[rows], lp))
    t_k = cuda_ms(torch, lambda: K.rank_counts(*big), reps=5, inner=1)
    # ops: per ordered pair of active keys (the pairs this input needs) a
    # weight comparison, two seed comparisons and one count update; bytes:
    # weight, two seeds, active read, h, l written
    n_act = int(big[3].sum())
    b_ms, b_by = bound(n_full * 13 + n_full * 8, 4.0 * n_act * n_act)
    print(f"K6 rankcount n={n_full} ({n_act} active): kernel {t_k:.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by}); n={n_small}: kernel "
          f"{t_small:.4f} ms, plain "
          f"{t_p:.4f} ms; exact at n={n_small} and on {K6_ROWS} sampled "
          f"rows at n={n_full}", flush=True)
    # ms and bound_ms are at n_full; the plain version's O(n^2) time is
    # taken at plain_n, beside the kernel's own time there
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, n=n_full, plain_n=n_small,
                ms_at_plain_n=t_small)


# ---------------------------------------------------------------------------
# phase 4: the metric tier at the Census1990 shape
# ---------------------------------------------------------------------------

def census_points(torch, dev, n: int):
    """n x 68 points of a 20-component Gaussian mixture, made on the card
    from a fixed seed: component means N(0, 7.5^2), spread 2.5, so
    |x|^2 ~ 4250 as in the published data's scale. Returns (X, means)."""
    g = torch.Generator(device=dev).manual_seed(1990)
    means = 7.5 * torch.randn((CENSUS_COMPONENTS, CENSUS_DIM), generator=g,
                              device=dev)
    label = torch.randint(0, CENSUS_COMPONENTS, (n,), generator=g,
                          device=dev)
    X = means[label] + 2.5 * torch.randn((n, CENSUS_DIM), generator=g,
                                         device=dev)
    return X.contiguous(), means


def counts_delta(K, before):
    now = K.launch_counts()
    return tuple(now[k] - before[k] for k in now)


def phase_metric(torch, C, K, dev, n: int = CENSUS_N):
    from repro_torch.launch.cluster import (ClusterEngine, _candidate_pool,
                                            kcenter, local_search)
    X, means = census_points(torch, dev, n)
    chunks = torch.tensor_split(X, CENSUS_CHUNKS)
    cfg = dict(dim=CENSUS_DIM, k=SLAB_K, mu=2.0, n_anchors=8, seed=0)
    eng = ClusterEngine(**cfg)
    want_fold = (1, 2, 1, 0, 0, 0)

    # the main path, counted from 0
    K.reset_launch_counts()
    absorb_ms = []
    for i, ch in enumerate(chunks):
        before = K.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.absorb(ch)
        torch.cuda.synchronize()
        absorb_ms.append((time.perf_counter() - t0) * 1e3)
        _check(counts_delta(K, before) == want_fold,
               f"absorb {i} launches {counts_delta(K, before)}, want "
               f"{want_fold}")
    _check(not eng.overflow, "metric slab overflowed")
    init = local_search(eng, k=CENSUS_COMPONENTS, n_cand=LS_CAND, rounds=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = local_search(eng, k=CENSUS_COMPONENTS, n_cand=LS_CAND,
                       rounds=LS_ROUNDS)
    ls_s = time.perf_counter() - t0
    ls_k5 = K.launch_counts()["servicecost"] - 1     # less init's scoring
    kc = kcenter(eng, CENSUS_COMPONENTS)
    counts = K.launch_counts()
    torch.cuda.synchronize()
    for name in ("seeds", "blockselect", "compact", "servicecost"):
        _check(counts[name] > 0, f"kernel {name} never launched on the "
               f"metric path")

    # one service_costs of Q <= 128
    q_one = C.cost_table(np.stack([res.centers, init.centers]), 2.0)
    before = K.launch_counts()
    eng.service_costs(q_one)
    _check(counts_delta(K, before) == (0, 0, 0, 0, 1, 0),
           f"service_costs launches {counts_delta(K, before)}")

    # the plain-path twin on the card: bit-equal slab, costs within rtol
    twin = ClusterEngine(use_kernels=False, **cfg)
    before = K.launch_counts()
    for ch in chunks:
        twin.absorb(ch)
    _check(counts_delta(K, before) == (0, 0, 0, 0, 0, 0),
           "the plain twin launched kernels")
    for name, a, b in zip(eng._sketch._fields, eng._sketch, twin._sketch):
        _check(torch.equal(a, b), f"metric twin: slab {name} differs")
    _check(torch.equal(eng._coords, twin._coords),
           "metric twin: coords differ")
    rng = np.random.default_rng(21)
    cand = _candidate_pool(eng, 4 * LS_CAND)
    sets = np.stack([cand[rng.choice(len(cand), CENSUS_COMPONENTS,
                                     replace=False)] for _ in range(30)])
    table = C.cost_table(np.concatenate(
        [means.cpu().numpy()[None], res.centers[None], sets]), 2.0)
    ka, kb = eng.service_costs(table), twin.service_costs(table)
    _check(np.allclose(ka, kb, rtol=1e-5, atol=0.0),
           f"metric twin: service costs beyond rtol 1e-5 (max rel "
           f"{np.max(np.abs(ka - kb) / np.abs(kb)):.3g})")

    # estimates against the exact costs over all n points
    exact = C.exact_service_costs(X, C.cost_table(np.stack(
        [means.cpu().numpy(), init.centers, res.centers]), 2.0)).cpu().numpy()
    est = eng.service_costs(C.cost_table(np.stack(
        [means.cpu().numpy(), init.centers]), 2.0))
    cvb = C.cv_bound(1.0, SLAB_K)
    for what, e, x in (("generator centers", est[0], exact[0]),
                       ("initial set", est[1], exact[1])):
        _check(abs(float(e) - float(x)) <= 4 * cvb * float(x),
               f"{what}: estimate {e} vs exact {x} beyond 4 cv "
               f"({4 * cvb:.4f})")
    _check(exact[2] <= exact[1], f"local search raised the exact cost: "
           f"{exact[1]} -> {exact[2]}")
    _check(all(a >= b for a, b in zip(res.history, res.history[1:])),
           "local search history not monotone")
    _check(abs(kc.coverage_est - kc.total_est) <= 1e-5 * kc.total_est,
           f"k-center coverage {kc.coverage_est} != total {kc.total_est}")
    idle, round_ms, dev_ms = round_idle_share(torch, eng, res.centers)
    print(f"metric tier n={n} dim={CENSUS_DIM} (capacity {eng.spec.cap}): "
          f"absorb ms p50 {np.percentile(absorb_ms, 50):.3f} p95 "
          f"{np.percentile(absorb_ms, 95):.3f} (first {absorb_ms[0]:.3f}); "
          f"launches per absorb {want_fold}, per service_costs "
          f"(0, 0, 0, 0, 1, 0); twin slab bit-equal, costs within rtol 1e-5; "
          f"local search {ls_s * 1e3:.3f} ms wall, {res.rounds} rounds, "
          f"{ls_k5} K5 launches; estimate/exact generator "
          f"{est[0] / exact[0]:.5f}, initial {est[1] / exact[1]:.5f} "
          f"(4 cv = {4 * cvb:.4f}); exact cost final/generator "
          f"{exact[2] / exact[0]:.5f}, initial/generator "
          f"{exact[1] / exact[0]:.5f}; k-center radius {kc.radius:.4f}, "
          f"coverage {kc.coverage_est:.1f} = total {kc.total_est:.1f}; one "
          f"round (641 sets) {round_ms:.3f} ms wall under the profiler, "
          f"device {dev_ms:.3f} ms, idle share {idle:.3f}", flush=True)
    return counts


def profiled(torch, fn):
    """fn() (synchronised) under the profiler: (device idle share, wall ms,
    device ms, the top device ops as "name ms" text)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted(((e.key, e.self_device_time_total / 1e3)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    dev_ms = sum(t for _, t in ops)
    top = ", ".join(f"{name[:40]} {t:.3f}" for name, t in ops[:4])
    return max(0.0, 1 - dev_ms / wall), wall, dev_ms, top


def round_idle_share(torch, eng, cur):
    """One local-search round's work from the center set ``cur`` (build the
    1 + k n_cand swap sets, score them through K5, argmin) under the
    profiler: (device idle share, wall ms, device ms)."""
    from repro_torch.core.costs import cost_table
    from repro_torch.launch.cluster import _candidate_pool, _swap_sets
    cand = _candidate_pool(eng, LS_CAND)

    def one_round():
        scores = eng.service_costs(cost_table(_swap_sets(cur, cand), eng.mu))
        int(np.argmin(scores[1:]))
    return profiled(torch, one_round)[:3]


# ---------------------------------------------------------------------------
# phase 5: the universal tier (examples/quickstart.py at 2^20 keys)
# ---------------------------------------------------------------------------

def phase_universal(torch, C, K, dev, n: int = UNIVERSAL_N,
                    shards: int = UNIVERSAL_SHARDS):
    from repro_torch.kernels import ops
    k = UNIVERSAL_K
    g = torch.Generator(device=dev).manual_seed(2015)
    keys = torch.arange(n, dtype=torch.int32, device=dev)
    w = (2.0 * torch.randn(n, generator=g, device=dev)).exp()
    act = torch.ones(n, dtype=torch.bool, device=dev)
    domain = torch.randint(0, 8, (n,), generator=g, device=dev)
    seg = domain == 3
    wall = {}

    def timed(name, fn):
        """fn's result; its wall time cold (the first call) and warm."""
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        wall[name] = times
        return out

    K.reset_launch_counts()
    # 1. one universal monotone sample, many statistics
    s = timed("universal_monotone_sample", lambda: C.universal_monotone_sample(
        keys, w, act, k, seed=42))
    size = int(s.member.sum())
    ebound = C.expected_size_bound(n, k)
    # E|S| <= ebound (Thm 5.1); one draw, a sum of indicators, gets 4 sigma
    _check(0 < size <= ebound + 4 * ebound ** 0.5,
           f"monotone sample size {size} vs E bound {ebound:.1f}")
    ratios = []
    for f in (C.COUNT, C.SUM, C.thresh(5.0), C.cap(2.0), C.moment(1.5)):
        est = float(C.estimate(f, w, s.prob, s.member, seg))
        ex = float(C.exact(f, w, act, seg))
        q = ex / float(C.exact(f, w, act))
        cvb = C.cv_bound(q, k)
        _check(abs(est - ex) <= 4 * cvb * ex, f"monotone {f.name} on domain "
               f"3: estimate {est} vs exact {ex} beyond 4 cv ({4 * cvb:.4f})")
        ratios.append(f"{f.name} {est / ex:.4f} (4cv {4 * cvb:.3f})")

    # 2. 16 shard sketches folded with merge_sketches
    cap = C.sketch_capacity(n, k)
    parts = torch.arange(n, device=dev).tensor_split(shards)
    fold_ms = []
    merged = None
    for p in parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sk = C.build_sketch(keys[p], w[p], act[p], k, cap, seed=42)
        merged = sk if merged is None else C.merge_sketches(merged, sk,
                                                            donate=True)
        torch.cuda.synchronize()
        fold_ms.append((time.perf_counter() - t0) * 1e3)
    whole = timed("build_sketch (whole set)",
                  lambda: C.build_sketch(keys, w, act, k, cap, seed=42))
    _check(not bool(merged.valid.all()), "merged sketch is full (capacity "
           f"{cap} too small)")
    _check(member_triples(torch, merged) == member_triples(torch, whole),
           "merged sketch's member (key, weight, prob) differ from the "
           "whole-set sketch's")
    sum_est = float(C.sketch_estimate(merged, C.SUM))
    sum_ex = float(w.double().sum())
    cvb = C.cv_bound(1.0, k)
    _check(abs(sum_est - sum_ex) <= 4 * cvb * sum_ex, f"merged sketch SUM "
           f"{sum_est} vs exact {sum_ex} beyond 4 cv")

    # 3. multi-objective bottom-k through K1 + K2 against the core sampler
    objs = ((0, 0.0), (3, 2.0), (1, 0.0))
    mk, pk = timed("multi_objective_bottomk_kernel",
                   lambda: ops.multi_objective_bottomk_kernel(
                       keys, w, act, objs, k, seed=42))
    core = timed("multi_bottomk_sample", lambda: C.multi_bottomk_sample(
        keys, w, act, [(ops.statfn_of(*o), k) for o in objs], seed=42))
    _check(torch.equal(mk, core.member), "multi-objective kernel members "
           "differ from multi_bottomk_sample's")
    _check(float((pk - core.prob).abs().max()) <= 1e-6,
           "multi-objective kernel probs beyond 1e-6 of the core's")

    # 4. universal capping: the sampler and K6 on the same keys
    g2 = torch.Generator(device=dev).manual_seed(2016)
    w2 = torch.randn(n, generator=g2, device=dev).exp().clamp(0.1, 10.0)
    cs = timed("universal_capping_sample", lambda: C.universal_capping_sample(
        keys, w2, act, k, m_cap=CAPPING_M_CAP, seed=42))
    ck, hl = timed("universal_capping_kernel",
                   lambda: ops.universal_capping_kernel(keys, w2, act, k,
                                                        seed=42))
    _check(torch.equal(ck, cs.member), "capping kernel members differ from "
           "universal_capping_sample's")
    _check(torch.equal(hl[act], cs.hl[act]), "capping kernel hl differs on "
           "active keys")
    csize = int(cs.member.sum())
    cbound = C.capping_size_bound(k, 10.0, 0.1)
    _check(0 < csize <= cbound, f"capping size {csize} > bound {cbound:.1f}")
    n_cand = int((act & (cs.hl <= k)).sum())
    _check(n_cand <= CAPPING_M_CAP, f"{n_cand} capping candidates > m_cap")
    cratios = []
    for T in (0.5, 1.0, 2.0, 5.0):
        f = C.cap(T)
        est = float(C.estimate(f, w2, cs.prob, cs.member))
        ex = float(C.exact(f, w2, act))
        _check(abs(est - ex) <= 4 * cvb * ex, f"capping cap_{T:g}: estimate "
               f"{est} vs exact {ex} beyond 4 cv")
        cratios.append(f"cap_{T:g} {est / ex:.4f}")
    counts = K.launch_counts()
    for name in ("seeds", "blockselect", "rankcount"):
        _check(counts[name] > 0, f"kernel {name} never launched on the "
               f"universal path")
    # where a warm sample's and a shard fold's time goes (refolding the
    # last shard leaves the merged sketch as it is)
    breakdown = {
        "monotone sample": profiled(torch, lambda: C.universal_monotone_sample(
            keys, w, act, k, seed=42)),
        "shard fold": profiled(torch, lambda: C.merge_sketches(
            merged, C.build_sketch(keys[parts[-1]], w[parts[-1]],
                                   act[parts[-1]], k, cap, seed=42)))}
    print(f"universal tier n={n} k={k}: monotone size {size} (E bound "
          f"{ebound:.1f}), domain-3 estimate/exact {'; '.join(ratios)}; "
          f"{shards} shard sketches (capacity {cap}) folded == whole-set "
          f"sketch, SUM estimate/exact {sum_est / sum_ex:.4f} (4 cv "
          f"{4 * cvb:.3f}); "
          f"one shard's build_sketch + merge_sketches fold ms p50 "
          f"{np.percentile(fold_ms, 50):.3f} p95 "
          f"{np.percentile(fold_ms, 95):.3f}; multi-objective kernel == "
          f"core sampler; capping size {csize} (bound {cbound:.1f}, "
          f"{n_cand} candidates), kernel == sampler, {', '.join(cratios)}; "
          f"wall ms (cold/warm): " + ", ".join(
              f"{a} {b[0]:.3f}/{b[1]:.3f}" for a, b in wall.items())
          + f"; launches {counts}", flush=True)
    for what, (idle, wall_ms, dev_ms, top) in breakdown.items():
        print(f"universal breakdown, one warm {what} under the profiler: "
              f"{wall_ms:.3f} ms wall, device {dev_ms:.3f} ms (idle share "
              f"{idle:.3f}); top device ops ms: {top}", flush=True)
    return counts


def member_triples(torch, sk):
    """A sketch's member slots as a sorted list of (key, weight, prob)."""
    m = sk.member & sk.valid
    return sorted(zip(sk.keys[m].tolist(), sk.weights[m].tolist(),
                      sk.probs[m].tolist()))


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch.core as C
    import repro_torch.kernels as K
    from repro_torch.kernels._util import kernel_lib
    from repro_torch.launch import pool as pool_mod
    from repro_torch.launch import query as query_mod

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernel_lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda")

    kstats = phase_kernels(torch, C, K, dev)
    kstats["servicecost"] = phase_k5(torch, K, dev)
    kernel_attributes(K)
    kstats["rankcount"] = phase_k6(torch, C, K, dev)
    counts = phase_serving(torch, C, K, pool_mod, query_mod)
    phase_durability(C, pool_mod)
    metric_counts = phase_metric(torch, C, K, dev)
    universal_counts = phase_universal(torch, C, K, dev)

    sources = {"seeds": ("seeds.cu", "seeds.py:58"),
               "blockselect": ("blockselect.cu", "blockselect.py:41"),
               "compact": ("compact.cu", "compact.py:39"),
               "segquery": ("segquery.cu", "segquery.py:44"),
               "servicecost": ("servicecost.cu", "servicecost.py:48"),
               "rankcount": ("rankcount.cu", "rankcount.py:30")}
    main_path = {"servicecost": metric_counts, "rankcount": universal_counts}
    rows = []
    for name, (cu, tpu) in sources.items():
        launches = main_path.get(name, counts)[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{cu}",
                     "replaces": f"src/repro/kernels/{tpu}",
                     "launches": launches, **kstats[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
