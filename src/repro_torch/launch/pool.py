"""Fault-tolerant multi-tenant serving tier: the EnginePool.

Many named MultiSketch streams (tenants) behind ONE admission loop, each
stream a resident ``SegmentQueryEngine`` wrapped in the failure machinery
a million-user deployment needs. The design premise is the paper's:
coordinated mergeable sketches make degraded-but-correct answers POSSIBLE
— a stale merged slab is still an unbiased HT estimator with a known
(slightly worse) cv — and the fixed-capacity wire format makes
recovery-by-merge exact. So the pool promises "never wrong, occasionally
stale" instead of "occasionally down":

  * ADMISSION & BACKPRESSURE — a bounded request queue; ``submit`` raises
    :class:`RejectedError` when it is full (load shedding, never unbounded
    memory). ``pump`` drains the queue and COALESCES same-(stream,
    objectives) requests into one fused B-bucket launch (the
    ``multisketch_query_many`` quantum machinery), so burst traffic pays
    one kernel launch per bucket, not one per request. Per-request
    deadlines: a request already past its deadline at service time is
    answered ``REJECTED`` (error "deadline"), never silently late.
  * RETRY / TIMEOUT / BACKOFF — transient absorb/query failures (e.g.
    injected device errors) are retried with exponential backoff +
    jitter; persistent failure trips a per-stream circuit breaker.
  * GRACEFUL DEGRADATION LADDER — ``FRESH`` -> ``STALE(epoch_lag)`` ->
    ``REJECTED``. A stream whose breaker is open (or whose fresh query
    path fails after retries) serves from its LAST-GOOD merged slab; a
    failed delta fold leaves data durable in the WAL and downgrades
    responses to ``STALE`` with the exact chunk lag. Every response
    carries its staleness level and the ``multisketch_overflow`` flag —
    degraded answers are still unbiased estimates, and they are LABELED.
  * INPUT QUARANTINE — NaN/inf/negative rows are rejected PER ROW at
    absorb (``core.multi_sketch.quarantine_chunk``) with a per-stream
    counter: one bad producer cannot poison a tenant's slab.
  * DURABILITY — per-stream WAL of absorbed chunks (``launch.wal``,
    fsync'd write-ahead of the fold) + periodic ``CheckpointManager``
    snapshots. Crash recovery = restore newest intact snapshot -> replay
    the WAL tail -> lazy merge, BIT-IDENTICAL to the uncrashed engine
    (asserted in tests/test_torch_pool.py).
  * ADMIN OPS — ``request_gc``/``gc``/``compact`` ride a separate admin
    queue on the same admission loop: each ``pump`` serves EVERY pending
    query first, then at most ONE admin op (GC never starves reads), with
    the same deadline semantics. A GC drains the stream's fold backlog,
    applies the engine's shard GC (``gc_plan``/``gc_apply``), then
    appends a WAL GC marker (``wal.GC_SHARD``) carrying the victim list —
    apply-then-append, so recovery replays the recorded decision and
    lands in the identical post-GC shard layout. Responses served while
    the engine's newest epoch is a GC epoch are labeled ``gc_epoch``.

Fault-injection hooks: every failure-prone operation funnels through a
named fault point (``_fault_point``); the chaos harness (tests/faults.py)
installs deterministic failure schedules there without monkeypatching
library internals. Production runs have zero hooks installed and pay one
dict lookup per operation.

Port of ``repro/launch/pool.py`` ``EnginePool`` (the multi-host
``ShardedEnginePool`` is not ported yet). ``EnginePool(device=None)`` runs
its engines on the CUDA card and raises without one; ``device="cpu"`` runs
them on the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.funcs import StatFn
from repro_torch.core.multi_sketch import (MultiSketchSpec,
                                           multisketch_overflow,
                                           multisketch_query_many,
                                           quarantine_chunk, spec_from_meta,
                                           spec_to_meta)
from repro_torch.core.predicates import EVERYTHING, encode_predicates
from repro_torch.launch.query import SegmentQueryEngine
from repro_torch.launch.wal import GC_SHARD, WriteAheadLog

# degradation-ladder response statuses (the serving contract, core.merge)
FRESH = "FRESH"
STALE = "STALE"
REJECTED = "REJECTED"


class RejectedError(RuntimeError):
    """Load shed: admission queue full / absorb backlog over its bound."""


class TransientFault(RuntimeError):
    """A retryable failure (an injected device error)."""


# -- fault-injection points (chaos harness contract) ------------------------
# name -> hook(stream_name); an installed hook RAISES to inject a fault.
_FAULT_HOOKS: Dict[str, Callable[[str], None]] = {}

FAULT_POINTS = ("absorb_fold", "query_merge", "wal_append", "wal_replay",
                "ckpt_save", "ckpt_restore")


def install_fault_hook(point: str, fn: Callable[[str], None]):
    if point not in FAULT_POINTS:
        raise ValueError(f"unknown fault point {point!r}")
    _FAULT_HOOKS[point] = fn


def clear_fault_hooks():
    _FAULT_HOOKS.clear()


def _fault_point(point: str, stream: str):
    fn = _FAULT_HOOKS.get(point)
    if fn is not None:
        fn(stream)


def _retry_loop(fn, *, retries: int, backoff_base: float, backoff_cap: float,
                rng: random.Random, sleep: Callable[[float], None]):
    """Exponential backoff + jitter around a failure-prone op.
    ``RejectedError`` (load shed) is not transient and propagates
    immediately."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except RejectedError:
            raise
        except Exception:
            if attempt == retries:
                raise
            delay = min(backoff_cap, backoff_base * (2 ** attempt))
            sleep(delay * (0.5 + rng.random()))


# -- responses ---------------------------------------------------------------

@dataclasses.dataclass
class Response:
    """One answered query. ``values`` is float [|F|, B] (None iff
    REJECTED); ``epoch_lag`` counts accepted-but-unreflected absorb chunks
    (0 iff the answer covers every ack'd chunk); ``overflow`` mirrors
    ``multisketch_overflow`` of the slab that produced the answer."""

    status: str
    values: Optional[np.ndarray] = None
    epoch_lag: int = 0
    overflow: bool = False
    error: Optional[str] = None
    # the served slab's newest epoch was produced by a shard-GC merge
    # (same union, compacted layout) — labeled, like staleness
    gc_epoch: bool = False
    # admin-op (gc/compact) responses only: victim shards merged
    gc_victims: Optional[Tuple[int, ...]] = None

    @property
    def ok(self) -> bool:
        return self.status != REJECTED


@dataclasses.dataclass
class AbsorbReceipt:
    """Ack for one absorb: rows accepted (durable once ``durable``),
    rows quarantined, and whether the device fold already applied."""

    accepted: int
    quarantined: int
    applied: bool
    durable: bool
    seq: int = 0


class PoolFuture:
    """Completion handle for a submitted query."""

    def __init__(self):
        self._event = threading.Event()
        self._response: Optional[Response] = None

    def _set(self, response: Response):
        self._response = response
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Response:
        if not self._event.wait(timeout):
            raise TimeoutError("query not served within timeout")
        return self._response


@dataclasses.dataclass
class _Request:
    stream: str
    fs: Tuple[StatFn, ...]
    table: np.ndarray           # encoded predicate rows [b, PRED_COLS]
    deadline: Optional[float]
    future: PoolFuture


@dataclasses.dataclass
class _GcRequest:
    stream: str
    max_live: Optional[int]
    min_age: Optional[int]
    deadline: Optional[float]
    future: PoolFuture


class CircuitBreaker:
    """Consecutive-failure breaker: closed -> open after ``threshold``
    failures; open admits one half-open probe after ``reset_after``
    seconds; a probe success closes it, a probe failure re-opens."""

    def __init__(self, threshold: int = 3, reset_after: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = int(threshold)
        self.reset_after = float(reset_after)
        self._clock = clock
        self._failures = 0
        self._opened_at: Optional[float] = None
        self.open_count = 0     # times the breaker tripped (health metric)

    @property
    def is_open(self) -> bool:
        return self._opened_at is not None

    def allow(self) -> bool:
        """May the protected operation be ATTEMPTED now? True when closed,
        or when open long enough for a half-open probe."""
        if self._opened_at is None:
            return True
        return self._clock() - self._opened_at >= self.reset_after

    def record_success(self):
        self._failures = 0
        self._opened_at = None

    def record_failure(self):
        self._failures += 1
        if self._failures >= self.threshold:
            if self._opened_at is None:
                self.open_count += 1
            self._opened_at = self._clock()


class _Stream:
    """One tenant: engine + breaker + WAL + staleness bookkeeping."""

    def __init__(self, name: str, engine: SegmentQueryEngine,
                 breaker: CircuitBreaker, wal: Optional[WriteAheadLog],
                 ckpt_dir: Optional[str]):
        self.name = name
        self.engine = engine
        self.breaker = breaker
        self.wal = wal
        self.ckpt_dir = ckpt_dir
        self.ingest_seq = 0       # chunks accepted (and WAL'd, if durable)
        self.applied_seq = 0      # chunks folded into the engine
        self.quarantined = 0      # malformed rows rejected per-row
        self.snapshot_failures = 0
        self.folds_since_snapshot = 0
        self.snapshot_seqs: list = []      # applied_seq at each snapshot
        # (applied_seq_at_capture, merged slab) — the degraded-read replica
        self.last_good = None
        # fold backlog: chunks ack'd (durable) but not yet applied —
        # bounded; the WAL holds them too, this just avoids re-reading it
        self.pending = deque()


class EnginePool:
    """Multi-tenant serving pool. See module docstring for the contract.

    ``pump`` is the admission loop body: call it from your serving loop
    (deterministic — what the tests and the chaos bench do) or let
    ``start()`` run it on a background thread.
    """

    def __init__(self, queue_depth: int = 128, pending_limit: int = 64,
                 retries: int = 3, backoff_base: float = 0.01,
                 backoff_cap: float = 0.5, breaker_threshold: int = 3,
                 breaker_reset: float = 1.0,
                 durability_dir: Optional[str] = None,
                 snapshot_every: int = 0, keep_snapshots: int = 3,
                 seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 device=None):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.device = resolve_device(device)
        self.queue_depth = int(queue_depth)
        self.pending_limit = int(pending_limit)
        self.retries = int(retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset = float(breaker_reset)
        self.durability_dir = durability_dir
        self.snapshot_every = int(snapshot_every)
        self.keep_snapshots = max(int(keep_snapshots), 1)
        self._rng = random.Random(seed)
        self._clock = clock
        self._sleep = sleep
        self._streams: Dict[str, _Stream] = {}
        self._queue: deque = deque()
        self._admin: deque = deque()   # gc/compact ops, served after queries
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- stream lifecycle ----------------------------------------------------
    def _stream_paths(self, name: str):
        base = os.path.join(self.durability_dir, name)
        return (os.path.join(base, "ckpt"), os.path.join(base, "wal.log"),
                os.path.join(base, "stream.json"))

    def create_stream(self, name: str, spec: MultiSketchSpec,
                      shards: int = 1, **engine_kw) -> SegmentQueryEngine:
        """Register a tenant stream. With a ``durability_dir``, the static
        stream config is persisted (stream.json) so ``EnginePool.open``
        can rebuild the engine even before its first snapshot."""
        if name in self._streams:
            raise ValueError(f"stream {name!r} already exists")
        engine = SegmentQueryEngine(spec, shards=shards, device=self.device,
                                    **engine_kw)
        wal = ckpt_dir = None
        if self.durability_dir is not None:
            ckpt_dir, wal_path, cfg_path = self._stream_paths(name)
            os.makedirs(os.path.dirname(cfg_path), exist_ok=True)
            with open(cfg_path, "w") as f:
                json.dump({"multisketch_spec": spec_to_meta(spec),
                           "shards": int(shards),
                           "engine_kw": {k: v for k, v in engine_kw.items()
                                         if k != "use_kernels"}}, f)
                f.flush()
                os.fsync(f.fileno())
            wal = WriteAheadLog(wal_path)
        self._streams[name] = _Stream(
            name, engine,
            CircuitBreaker(self.breaker_threshold, self.breaker_reset,
                           self._clock),
            wal, ckpt_dir)
        return engine

    @classmethod
    def open(cls, durability_dir: str, **kw) -> "EnginePool":
        """Recover a pool from its durability directory: every stream is
        restored from its newest intact checkpoint (falling back across
        corrupt steps), then its WAL tail replayed — bit-identical to the
        uncrashed engines."""
        pool = cls(durability_dir=durability_dir, **kw)
        if os.path.isdir(durability_dir):
            for name in sorted(os.listdir(durability_dir)):
                if os.path.isfile(os.path.join(durability_dir, name,
                                               "stream.json")):
                    pool.restore_stream(name)
        return pool

    def restore_stream(self, name: str) -> SegmentQueryEngine:
        """Restore one stream: checkpoint (if any) -> WAL-tail replay."""
        if self.durability_dir is None:
            raise ValueError("pool has no durability_dir")
        ckpt_dir, wal_path, cfg_path = self._stream_paths(name)
        with open(cfg_path) as f:
            cfg = json.load(f)
        spec = spec_from_meta(cfg["multisketch_spec"])
        applied = 0
        engine = None
        _fault_point("ckpt_restore", name)
        try:
            engine, extra = SegmentQueryEngine.from_checkpoint(
                ckpt_dir, return_meta=True, device=self.device)
            applied = int(extra.get("pool_applied_seq", 0))
        except FileNotFoundError:
            pass                       # pre-first-snapshot: replay-only
        if engine is None:
            engine = SegmentQueryEngine(spec, shards=int(cfg["shards"]),
                                        device=self.device,
                                        **cfg.get("engine_kw", {}))
        wal = WriteAheadLog(wal_path)
        st = _Stream(name, engine,
                     CircuitBreaker(self.breaker_threshold,
                                    self.breaker_reset, self._clock),
                     wal, ckpt_dir)
        _fault_point("wal_replay", name)
        seq = applied
        for rec in wal.replay(min_seq_exclusive=applied):
            if rec.shard < 0:
                # GC marker: re-apply the RECORDED victim list, so the
                # restored shard layout matches the uncrashed engine's
                engine.gc_apply([int(x) for x in rec.keys])
            else:
                engine.absorb(rec.keys, rec.weights, rec.active,
                              shard=rec.shard)
            seq = rec.seq
        st.ingest_seq = st.applied_seq = seq
        self._streams[name] = st
        return engine

    def close(self):
        self.stop()
        for st in self._streams.values():
            if st.wal is not None:
                st.wal.close()

    # -- ingest (absorb + quarantine + WAL + retry/breaker) ------------------
    def absorb(self, name: str, keys, weights, shard: int = 0
               ) -> AbsorbReceipt:
        """Ingest one chunk into a tenant stream.

        Order of operations is the durability contract: quarantine ->
        WAL append (fsync) -> device fold with retries. A chunk whose fold
        fails (breaker opens) is still DURABLE and still counted in
        ``ingest_seq`` — queries degrade to ``STALE(epoch_lag)`` until the
        backlog replays. Backlog past ``pending_limit`` sheds load with
        :class:`RejectedError` (bounded memory, never silent loss: the
        rejected chunk was not ack'd)."""
        if shard < 0:
            raise ValueError(
                f"shard must be >= 0, got {shard} (negative values are "
                f"reserved for WAL control records)")
        st = self._stream(name)
        k, w, act, n_bad = quarantine_chunk(keys, weights)
        st.quarantined += n_bad
        accepted = int(np.count_nonzero(act))
        if accepted == 0:
            return AbsorbReceipt(0, n_bad, applied=True,
                                 durable=st.wal is not None,
                                 seq=st.ingest_seq)
        if len(st.pending) >= self.pending_limit:
            raise RejectedError(
                f"stream {name!r} fold backlog full "
                f"({len(st.pending)} chunks)")
        seq = st.ingest_seq + 1
        if st.wal is not None:
            _fault_point("wal_append", name)
            st.wal.append(seq, shard, k, w, act.astype(np.uint8))
        st.ingest_seq = seq
        st.pending.append((seq, int(shard), k, w, act))
        applied = False
        if st.breaker.allow():
            applied = self._drain_pending(st)
            if applied:
                self._maybe_snapshot(st)
        return AbsorbReceipt(accepted, n_bad, applied=applied,
                             durable=st.wal is not None, seq=seq)

    def _drain_pending(self, st: _Stream) -> bool:
        """Fold the backlog in sequence order; True iff fully applied."""
        while st.pending:
            seq, shard, k, w, act = st.pending[0]
            try:
                self._with_retries(
                    lambda: self._fold_one(st, shard, k, w, act), st.name)
            except Exception:
                st.breaker.record_failure()
                return False
            st.breaker.record_success()
            st.pending.popleft()
            st.applied_seq = seq
            st.folds_since_snapshot += 1
        # charge the device work to the ingest path: the folds (and the
        # absorb-time merged-slab maintenance riding them) finish HERE,
        # so the next query never drains this epoch's backlog on its
        # critical path — the zero-merge query contract in wall-clock
        # terms, not just dispatch counts
        st.engine.drain()
        return True

    def _fold_one(self, st: _Stream, shard, k, w, act):
        _fault_point("absorb_fold", st.name)
        st.engine.absorb(k, w, act, shard=shard)

    # -- durability snapshots ------------------------------------------------
    def _maybe_snapshot(self, st: _Stream):
        if (self.snapshot_every and st.ckpt_dir is not None
                and st.folds_since_snapshot >= self.snapshot_every):
            try:
                self.snapshot(st.name)
            except Exception:
                st.snapshot_failures += 1   # WAL still covers everything

    def snapshot(self, name: str):
        """Checkpoint a stream's engine (atomic, crc'd) stamping the
        applied sequence, then prune the WAL to records newer than the
        oldest RETAINED snapshot (recovery from any kept step stays
        possible)."""
        st = self._stream(name)
        if st.ckpt_dir is None:
            raise ValueError(f"stream {name!r} is not durable")
        _fault_point("ckpt_save", name)
        st.engine.save_checkpoint(
            st.ckpt_dir, extra_meta={"pool_applied_seq": st.applied_seq})
        st.folds_since_snapshot = 0
        st.snapshot_seqs.append(st.applied_seq)
        if st.wal is not None and len(st.snapshot_seqs) >= self.keep_snapshots:
            st.wal.prune(st.snapshot_seqs[-self.keep_snapshots])

    # -- admission (submit / pump / query) -----------------------------------
    def submit(self, name: str, fs: Optional[Sequence[StatFn]] = None,
               predicates=EVERYTHING, timeout: Optional[float] = None
               ) -> PoolFuture:
        """Enqueue a segment-query batch; raises :class:`RejectedError`
        when the admission queue is full (load shedding)."""
        st = self._stream(name)
        fs = (tuple(f for f, _ in st.engine.spec.objectives) if fs is None
              else tuple(fs))
        table = np.asarray(encode_predicates(predicates), np.int32)
        fut = PoolFuture()
        deadline = None if timeout is None else self._clock() + timeout
        with self._lock:
            if len(self._queue) >= self.queue_depth:
                raise RejectedError(
                    f"admission queue full ({self.queue_depth})")
            self._queue.append(_Request(name, fs, table, deadline, fut))
        return fut

    def pump(self) -> int:
        """Drain the admission queue once: drop expired requests
        (REJECTED/"deadline"), coalesce the rest by (stream, objectives)
        and serve each group as ONE fused B-bucket launch; then serve at
        most ONE pending admin op (gc/compact) — queries always go first,
        so maintenance never starves reads. Returns the number of
        requests answered (queries + admin)."""
        with self._lock:
            batch = list(self._queue)
            self._queue.clear()
            admin = self._admin.popleft() if self._admin else None
        served = 0
        groups: Dict[Tuple[str, Tuple[StatFn, ...]], list] = {}
        for r in batch:
            # >= : a deadline EQUAL to now is already expired — timeout=0
            # must shed, not serve (a zero budget can never be met)
            if r.deadline is not None and self._clock() >= r.deadline:
                r.future._set(Response(REJECTED, error="deadline"))
                continue
            groups.setdefault((r.stream, r.fs), []).append(r)
        served += len(batch)
        for (name, fs), reqs in groups.items():
            table = np.concatenate([r.table for r in reqs])
            resp = self._serve_group(self._stream(name), fs, table)
            col = 0
            for r in reqs:
                b = r.table.shape[0]
                vals = (None if resp.values is None
                        else resp.values[:, col:col + b])
                col += b
                r.future._set(dataclasses.replace(resp, values=vals))
        if admin is not None:
            if (admin.deadline is not None
                    and self._clock() >= admin.deadline):
                admin.future._set(Response(REJECTED, error="deadline"))
            else:
                admin.future._set(self._do_gc(self._stream(admin.stream),
                                              admin.max_live,
                                              admin.min_age))
            served += 1
        return served

    def query(self, name: str, fs: Optional[Sequence[StatFn]] = None,
              predicates=EVERYTHING, timeout: Optional[float] = None
              ) -> Response:
        """Synchronous convenience: submit + pump + result. Use
        submit/pump (or ``start()``) for real batched serving."""
        fut = self.submit(name, fs, predicates, timeout)
        self.pump()
        return fut.result(timeout=None if timeout is None else timeout + 1.0)

    # -- admin ops (shard GC / compaction) -----------------------------------
    def request_gc(self, name: str, max_live: Optional[int] = None,
                   min_age: Optional[int] = None,
                   timeout: Optional[float] = None) -> PoolFuture:
        """Enqueue a shard-GC admin op for one stream. Served by ``pump``
        AFTER every pending query (at most one admin op per pump — a
        long compaction can only ever delay other maintenance, never a
        read). Deadline-aware like queries: an op past its deadline is
        answered REJECTED/"deadline". The response's ``gc_victims`` lists
        the shards merged (empty tuple: nothing eligible)."""
        self._stream(name)                 # validate up front
        fut = PoolFuture()
        deadline = None if timeout is None else self._clock() + timeout
        with self._lock:
            self._admin.append(_GcRequest(name, max_live, min_age,
                                          deadline, fut))
        return fut

    def gc(self, name: str, max_live: Optional[int] = None,
           min_age: Optional[int] = None,
           timeout: Optional[float] = None) -> Response:
        """Synchronous shard GC: request + pump + result."""
        fut = self.request_gc(name, max_live, min_age, timeout)
        self.pump()
        return fut.result(timeout=None if timeout is None else timeout + 1.0)

    def compact(self, name: str, timeout: Optional[float] = None
                ) -> Response:
        """Full compaction: merge every live shard into the base slab."""
        return self.gc(name, max_live=1, timeout=timeout)

    def _do_gc(self, st: _Stream, max_live, min_age) -> Response:
        """Apply a shard GC under the durability contract: drain the fold
        backlog first (the plan must see every applied chunk, and the WAL
        marker must sequence AFTER the data it follows), apply the merge,
        THEN append the GC marker. Apply-then-append: a crash between the
        two loses only the GC directive — recovery replays the data into
        the pre-GC layout, whose merged union (hence every answer) is
        identical."""
        if st.pending:
            ok = st.breaker.allow() and self._drain_pending(st)
            if not ok:
                return Response(REJECTED,
                                error="fold backlog not applied (breaker)")
        victims = st.engine.gc_plan(max_live, min_age)
        if not victims:
            return Response(FRESH, gc_victims=())
        try:
            st.engine.gc_apply(victims)
        except Exception as e:
            st.breaker.record_failure()
            return Response(REJECTED, error=f"{type(e).__name__}: {e}")
        err = None
        seq = st.ingest_seq + 1
        if st.wal is not None:
            try:
                _fault_point("wal_append", st.name)
                v = np.asarray(victims, np.int32)
                st.wal.append(seq, GC_SHARD, v,
                              np.zeros(len(victims), np.float32),
                              np.ones(len(victims), np.uint8))
            except Exception as e:
                # GC applied but the marker is lost: recovery replays into
                # the pre-GC layout — same union, so answers are identical
                err = f"gc marker not durable: {type(e).__name__}: {e}"
        st.ingest_seq = seq
        st.applied_seq = seq
        return Response(FRESH, gc_epoch=True, gc_victims=tuple(victims),
                        error=err)

    # -- the degradation ladder ----------------------------------------------
    def _serve_group(self, st: _Stream, fs, table) -> Response:
        err = None
        if st.breaker.allow():
            try:
                vals = self._with_retries(
                    lambda: self._query_engine(st, fs, table), st.name)
                st.breaker.record_success()
                # refresh the degraded-read replica: the handed-out handle
                # stays valid across later folds (engine contract)
                st.last_good = (st.applied_seq, st.engine.merged)
                lag = st.ingest_seq - st.applied_seq
                return Response(FRESH if lag == 0 else STALE, vals,
                                epoch_lag=lag,
                                overflow=bool(
                                    st.engine.merge_stats["overflow"]),
                                gc_epoch=(st.engine.last_gc_epoch
                                          == st.engine.epoch))
            except Exception as e:
                st.breaker.record_failure()
                err = f"{type(e).__name__}: {e}"
        # degraded: answer from the last-good merged slab — an older epoch
        # of the SAME unbiased estimator (exact merge contract), labeled
        if st.last_good is not None:
            base_seq, slab = st.last_good
            vals = multisketch_query_many(
                slab, fs, table, b_quantum=st.engine.b_quantum,
                use_kernels=st.engine.use_kernels)
            return Response(STALE, vals,
                            epoch_lag=st.ingest_seq - base_seq,
                            overflow=bool(multisketch_overflow(slab)),
                            error=err)
        return Response(REJECTED, error=err or "breaker open, no last-good")

    def _query_engine(self, st: _Stream, fs, table) -> np.ndarray:
        _fault_point("query_merge", st.name)
        return st.engine.query_many(fs, table)

    def _with_retries(self, fn, stream: str):
        """Exponential backoff + jitter around a failure-prone op."""
        return _retry_loop(fn, retries=self.retries,
                           backoff_base=self.backoff_base,
                           backoff_cap=self.backoff_cap,
                           rng=self._rng, sleep=self._sleep)

    # -- background admission loop -------------------------------------------
    def start(self, interval: float = 0.001):
        """Run ``pump`` on a daemon thread until ``stop()``."""
        if self._worker is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if self.pump() == 0:
                    self._stop.wait(interval)
        self._worker = threading.Thread(target=loop, daemon=True)
        self._worker.start()

    def stop(self):
        if self._worker is not None:
            self._stop.set()
            self._worker.join()
            self._worker = None

    # -- health --------------------------------------------------------------
    def _stream(self, name: str) -> _Stream:
        try:
            return self._streams[name]
        except KeyError:
            raise KeyError(f"unknown stream {name!r}") from None

    @property
    def streams(self):
        return tuple(self._streams)

    def queue_len(self) -> int:
        with self._lock:
            return len(self._queue)

    def stats(self, name: str) -> dict:
        """Health snapshot: staleness lag, quarantine count, breaker
        state, snapshot failures, and the engine's merge/overflow stats."""
        st = self._stream(name)
        return {"ingest_seq": st.ingest_seq, "applied_seq": st.applied_seq,
                "epoch_lag": st.ingest_seq - st.applied_seq,
                "pending": len(st.pending), "quarantined": st.quarantined,
                "breaker_open": st.breaker.is_open,
                "breaker_opens": st.breaker.open_count,
                "snapshot_failures": st.snapshot_failures,
                "gc_epoch": st.engine.last_gc_epoch == st.engine.epoch,
                "merge_stats": dict(st.engine.merge_stats)}

