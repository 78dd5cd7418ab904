#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

0. the card's name and power limit (nvidia-smi), then the nvcc build of the
   four CUDA kernels from ``src/repro_torch/kernels/csrc``;
1. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (the 8-objective smoke spec, k = 1024 each, capacity
   8201), with the kernel's, the plain version's and, where one exists, a
   single PyTorch call's time (CUDA events, median of 21);
2. serving through ``EnginePool``: 3 tenants x 4 shards, 16 chunks of
   1,048,576 rows each, interleaved with 32 submitted query batches
   (B = 128, all 8 objectives) per tenant; every response FRESH, the
   whole-stream sum/count estimates within 4 cv of the exact values, a
   plain-path twin engine bit-equal, the last round's pumped answers
   bit-equal to direct queries, and one absorb / one query moving the
   kernel launch counters by exactly (2, 4, 2, 0) / (0, 0, 0, 1);
3. durability: snapshot + WAL tail, close, ``EnginePool.open``, answers
   bit-identical.

Prints the card line, a ``{"kernels": [...]}`` line (launch counts from
phase 2, errors and times from phase 1) and, last, ``{"ok": true, ...}``.
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
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
REPS = 21


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
    for name, n in counts.items():
        _check(n > 0, f"kernel {name} never launched on the main path")
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
    want_a = {"seeds": 2, "blockselect": 4, "compact": 2, "segquery": 0}
    want_q = {"seeds": 0, "blockselect": 0, "compact": 0, "segquery": 1}
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
    counts = phase_serving(torch, C, K, pool_mod, query_mod)
    phase_durability(C, pool_mod)

    sources = {"seeds": ("seeds.cu", "seeds.py:58"),
               "blockselect": ("blockselect.cu", "blockselect.py:41"),
               "compact": ("compact.cu", "compact.py:39"),
               "segquery": ("segquery.cu", "segquery.py:44")}
    rows = []
    for name, (cu, tpu) in sources.items():
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{cu}",
                     "replaces": f"src/repro/kernels/{tpu}",
                     "launches": counts[name], **kstats[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
