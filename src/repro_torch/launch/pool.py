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

SCALE-OUT (``ShardedEnginePool``): the multi-HOST tier over the same
machinery. Each named stream's shards are partitioned across a host group
by rendezvous (consistent-hash) placement over the existing shard
indices; absorbs fan out to the owner host's resident engine, and queries
merge the per-host merged slabs through ONE stacked re-selection
(``launch.summary.merge_host_slabs`` — exact by threshold closure and
bit-identical to a single-host union engine). Each stream's last-good
merged slab is replicated to a primary + one FOLLOWER host on every
successful read, so queries survive a host loss at STALE status.
Membership change is driven entirely by WAL replay: a ``REBALANCE`` marker
(``wal.REBALANCE_SHARD``) logs the full shard->host re-partition under the
same apply-then-append discipline as GC markers, so recovery replays data
+ GC + rebalance markers in seq order into the identical post-move layout
— and a marker lost to a crash merely recovers the PRE-move placement,
whose merged union (hence every answer) is bit-identical. The hosts are
in-process failure domains that share one device.

Port of ``repro/launch/pool.py``. ``EnginePool(device=None)`` and
``ShardedEnginePool(device=None)`` run their engines on the CUDA card and
raise without one; ``device="cpu"`` runs them on the plain PyTorch
versions of the kernels.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import struct
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.funcs import StatFn
from repro_torch.core.multi_sketch import (MultiSketch, MultiSketchSpec,
                                           multisketch_overflow,
                                           multisketch_query_many,
                                           quarantine_chunk, spec_from_meta,
                                           spec_to_meta)
from repro_torch.core.predicates import EVERYTHING, encode_predicates
from repro_torch.launch.query import SegmentQueryEngine
from repro_torch.launch.summary import merge_host_slabs
from repro_torch.launch.wal import GC_SHARD, REBALANCE_SHARD, WriteAheadLog

# degradation-ladder response statuses (the serving contract, core.merge)
FRESH = "FRESH"
STALE = "STALE"
REJECTED = "REJECTED"


class RejectedError(RuntimeError):
    """Load shed: admission queue full / absorb backlog over its bound."""


class TransientFault(RuntimeError):
    """A retryable failure (an injected device error)."""


class HostDownError(RuntimeError):
    """A scale-out operation targeted a dead host. NOT retryable: the
    host stays dead until a rebalance moves its shards — callers degrade
    immediately (replica read / pending backlog) instead of burning the
    retry budget."""


# -- fault-injection points (chaos harness contract) ------------------------
# name -> hook(stream_name); an installed hook RAISES to inject a fault.
# ``host_op`` fires once per per-host engine operation of the scale-out
# pool, with the label "<stream>@h<host_id>" — host-kill schedules hook it
# to drop a host at a deterministic operation index (tests/faults.py).
_FAULT_HOOKS: Dict[str, Callable[[str], None]] = {}

FAULT_POINTS = ("absorb_fold", "query_merge", "wal_append", "wal_replay",
                "ckpt_save", "ckpt_restore", "host_op")


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
    """Exponential backoff + jitter around a failure-prone op (shared by
    the single-host and scale-out pools). ``RejectedError`` (load shed)
    and ``HostDownError`` (dead until rebalanced) are not transient and
    propagate immediately."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except (RejectedError, HostDownError):
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



# ===========================================================================
# Scale-out: the multi-host pool
# ===========================================================================

def rendezvous_owner(shard: int, hosts: Sequence[int]) -> int:
    """Consistent-hash owner of one shard over a host set: highest-random-
    weight (rendezvous) hashing on ``crc32(shard, host)``. Deterministic
    across processes (crc32, not the salted builtin ``hash``), and MINIMAL
    under membership change: removing a host moves only ITS shards,
    adding one steals only the shards it now wins."""
    best = -1
    best_score = -1
    for h in sorted(int(x) for x in hosts):
        score = zlib.crc32(struct.pack("<qq", int(shard), h))
        if score > best_score:
            best, best_score = h, score
    if best < 0:
        raise ValueError("rendezvous over an empty host set")
    return best


def compute_placement(shards: int, hosts: Sequence[int]) -> List[int]:
    """shard index -> owner host id, for every global shard."""
    return [rendezvous_owner(s, hosts) for s in range(int(shards))]


@dataclasses.dataclass
class _Host:
    """One in-process host of the group: per-stream resident engines plus
    the replicated last-good slabs it holds for degraded reads. A kill
    drops everything in memory — only the WAL/checkpoints survive."""

    hid: int
    alive: bool = True
    engines: Dict[str, SegmentQueryEngine] = dataclasses.field(
        default_factory=dict)
    # stream -> (applied_seq_at_capture, merged slab): the follower copy
    replicas: Dict[str, Tuple[int, MultiSketch]] = dataclasses.field(
        default_factory=dict)


class _ShardedStream:
    """One scale-out tenant: placement + WAL + staleness bookkeeping.

    The per-host data lives in the hosts' engines; this object owns only
    what must survive host churn — the shard->host placement, the ingest/
    applied sequence frontier, and the durable handles."""

    def __init__(self, name: str, spec: MultiSketchSpec, shards: int,
                 engine_kw: dict, wal: Optional[WriteAheadLog],
                 ckpt_dir: Optional[str], initial_hosts: Sequence[int]):
        self.name = name
        self.spec = spec
        self.shards = int(shards)
        self.engine_kw = dict(engine_kw)
        self.b_quantum = int(self.engine_kw.get("b_quantum", 16))
        self.use_kernels = self.engine_kw.get("use_kernels")
        self.wal = wal
        self.ckpt_dir = ckpt_dir
        # creation-time host set: the replay BASE — recovery recomputes
        # this placement first, then folds REBALANCE markers over it
        self.initial_hosts = tuple(int(h) for h in initial_hosts)
        self.placement: List[int] = compute_placement(shards,
                                                      self.initial_hosts)
        self.placement_version = 0
        self.ingest_seq = 0       # chunks accepted (and WAL'd, if durable)
        self.applied_seq = 0      # prefix folded into owner engines
        self.quarantined = 0
        self.folds_since_snapshot = 0
        self.snapshot_seqs: list = []
        # fold backlog: ack'd (durable) but not yet applied — chunks whose
        # owner host is dead (or whose fold faulted) wait here
        self.pending = deque()
        # cross-host merged slab, memoized on (placement_version, per-owner
        # engine epochs): steady-state reads pay ZERO merge work
        self.cross_cache: Optional[tuple] = None
        self.cross_merges = 0     # stacked re-selections actually run


class ShardedEnginePool:
    """Multi-host serving pool: shards partitioned across a host group.

    The single-host ``EnginePool`` contract ("never wrong, occasionally
    stale"), horizontally scaled — see the module docstring's SCALE-OUT
    section. In-process hosts model the failure domains: ``kill_host``
    drops one host's resident engines and replicas exactly as a machine
    loss would, and the durability story (WAL + snapshots + markers) is
    what brings its shards back, bit-identically, on another host.

    Write path: quarantine -> WAL append -> fold on the owner host (with
    retries; a dead owner leaves the chunk pending and queries STALE).
    Read path: one stacked re-selection over the live owners' merged
    slabs, memoized per (placement, engine epochs); on failure the newest
    surviving replica serves at STALE; only a total wipe answers REJECTED.
    ``device=None`` puts every host's engines on the CUDA card (raises
    without one); ``device="cpu"`` runs them on the plain versions.
    """

    def __init__(self, hosts: Sequence[int] = (0, 1, 2, 3),
                 pending_limit: int = 64,
                 retries: int = 3, backoff_base: float = 0.01,
                 backoff_cap: float = 0.5,
                 durability_dir: Optional[str] = None,
                 snapshot_every: int = 0, keep_snapshots: int = 3,
                 seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 device=None):
        ids = sorted({int(h) for h in hosts})
        if not ids:
            raise ValueError("need >= 1 host")
        self.device = resolve_device(device)
        self._hosts: Dict[int, _Host] = {h: _Host(h) for h in ids}
        self.pending_limit = int(pending_limit)
        self.retries = int(retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.durability_dir = durability_dir
        self.snapshot_every = int(snapshot_every)
        self.keep_snapshots = max(int(keep_snapshots), 1)
        self._rng = random.Random(seed)
        self._clock = clock
        self._sleep = sleep
        self._streams: Dict[str, _ShardedStream] = {}
        if durability_dir is not None:
            os.makedirs(durability_dir, exist_ok=True)
            self._save_hosts()

    # -- host membership -----------------------------------------------------
    @property
    def hosts(self) -> Tuple[int, ...]:
        return tuple(sorted(self._hosts))

    @property
    def live_hosts(self) -> Tuple[int, ...]:
        return tuple(h for h in sorted(self._hosts)
                     if self._hosts[h].alive)

    def _hosts_path(self) -> str:
        return os.path.join(self.durability_dir, "hosts.json")

    def _save_hosts(self):
        with open(self._hosts_path(), "w") as f:
            json.dump({"hosts": list(self.hosts)}, f)
            f.flush()
            os.fsync(f.fileno())

    def kill_host(self, hid: int):
        """Simulate losing one host: its resident engines AND replicas
        vanish (in-memory state only — the WAL and checkpoints are the
        surviving copy). Queries over streams whose shards it owned
        degrade to the newest surviving replica (STALE) until
        ``rebalance`` re-partitions; absorbs destined to it stay pending
        (durable, ack'd). Membership (hosts.json) is NOT rewritten."""
        h = self._host(hid)
        h.alive = False
        h.engines = {}
        h.replicas = {}
        for st in self._streams.values():
            st.cross_cache = None

    def host_join(self, hid: int):
        """Add a new (empty) host to the group. Placement is unchanged
        until the caller runs ``rebalance``."""
        hid = int(hid)
        if hid in self._hosts:
            raise ValueError(f"host {hid} already in the group")
        self._hosts[hid] = _Host(hid)
        if self.durability_dir is not None:
            self._save_hosts()

    def host_leave(self, hid: int):
        """Graceful decommission: rebalance every stream's shards OFF the
        host (live hand-offs, REBALANCE markers) while it is still alive,
        then drop it from the group."""
        h = self._host(hid)
        if h.alive and len(self.live_hosts) <= 1:
            raise RuntimeError("cannot decommission the last live host")
        if h.alive:
            self.rebalance(exclude=(hid,))
        del self._hosts[hid]
        if self.durability_dir is not None:
            self._save_hosts()

    def _host(self, hid: int) -> _Host:
        try:
            return self._hosts[int(hid)]
        except KeyError:
            raise KeyError(f"unknown host {hid!r}") from None

    def _host_alive(self, hid: int) -> bool:
        h = self._hosts.get(int(hid))
        return h is not None and h.alive

    def _new_engine(self, st: _ShardedStream) -> SegmentQueryEngine:
        return SegmentQueryEngine(st.spec, shards=st.shards,
                                  device=self.device, **st.engine_kw)

    def _host_engine(self, st: _ShardedStream, host: _Host
                     ) -> SegmentQueryEngine:
        """The host's resident engine for one stream, created on first
        touch. Engines are FULL-WIDTH (every global shard): un-owned
        shards stay parked on the shared inert slab, so global shard
        indices address any host uniformly."""
        eng = host.engines.get(st.name)
        if eng is None:
            eng = self._new_engine(st)
            host.engines[st.name] = eng
        return eng

    # -- stream lifecycle ----------------------------------------------------
    def _stream_paths(self, name: str):
        base = os.path.join(self.durability_dir, name)
        return (os.path.join(base, "ckpt"), os.path.join(base, "wal.log"),
                os.path.join(base, "stream.json"))

    def create_stream(self, name: str, spec: MultiSketchSpec,
                      shards: int = 4, **engine_kw) -> Tuple[int, ...]:
        """Register a tenant stream, partitioned over the CURRENT live
        hosts; returns the shard->host placement. With a
        ``durability_dir`` the static config (spec, shard count, the
        creation-time host set that seeds placement replay) is persisted
        so ``open`` can rebuild the stream before its first snapshot."""
        if name in self._streams:
            raise ValueError(f"stream {name!r} already exists")
        if int(shards) < 1:
            raise ValueError(f"need >= 1 shard, got {shards}")
        live = self.live_hosts
        if not live:
            raise RuntimeError("no live hosts")
        wal = ckpt_dir = None
        if self.durability_dir is not None:
            ckpt_dir, wal_path, cfg_path = self._stream_paths(name)
            os.makedirs(os.path.dirname(cfg_path), exist_ok=True)
            with open(cfg_path, "w") as f:
                json.dump({"multisketch_spec": spec_to_meta(spec),
                           "shards": int(shards),
                           "hosts": list(live),
                           "engine_kw": {k: v for k, v in engine_kw.items()
                                         if k != "use_kernels"}}, f)
                f.flush()
                os.fsync(f.fileno())
            wal = WriteAheadLog(wal_path)
        st = _ShardedStream(name, spec, shards, engine_kw, wal, ckpt_dir,
                            initial_hosts=live)
        self._streams[name] = st
        return tuple(st.placement)

    @classmethod
    def open(cls, durability_dir: str, hosts: Optional[Sequence[int]] = None,
             **kw) -> "ShardedEnginePool":
        """Recover a pool from its durability directory: the host group
        comes from hosts.json (or ``hosts``), then every stream replays
        checkpoint + WAL tail — data records, GC markers and REBALANCE
        markers in seq order — landing in the identical post-move layout
        the crashed pool had."""
        if hosts is None:
            with open(os.path.join(durability_dir, "hosts.json")) as f:
                hosts = json.load(f)["hosts"]
        pool = cls(hosts=hosts, durability_dir=durability_dir, **kw)
        for name in sorted(os.listdir(durability_dir)):
            if os.path.isfile(os.path.join(durability_dir, name,
                                           "stream.json")):
                pool.restore_stream(name)
        return pool

    def restore_stream(self, name: str) -> Tuple[int, ...]:
        """Restore one stream and distribute its shards to the replayed
        placement's owners. A shard whose replayed owner is dead/absent
        stays undistributed (its data is only in the WAL): queries
        degrade until ``rebalance`` re-partitions and rebuilds it."""
        if self.durability_dir is None:
            raise ValueError("pool has no durability_dir")
        ckpt_dir, wal_path, cfg_path = self._stream_paths(name)
        with open(cfg_path) as f:
            cfg = json.load(f)
        st = _ShardedStream(name, spec_from_meta(cfg["multisketch_spec"]),
                            int(cfg["shards"]), cfg.get("engine_kw", {}),
                            WriteAheadLog(wal_path), ckpt_dir,
                            initial_hosts=cfg["hosts"])
        sub, seq, placement = self._replay_substrate(st)
        st.placement = list(placement)
        for s in range(st.shards):
            h = self._hosts.get(st.placement[s])
            if h is not None and h.alive and sub.shard_live(s):
                self._host_engine(st, h).set_shard(s, sub.shard_slab(s))
        st.ingest_seq = st.applied_seq = seq
        self._streams[name] = st
        return tuple(st.placement)

    def close(self):
        for st in self._streams.values():
            if st.wal is not None:
                st.wal.close()

    # -- recovery substrate --------------------------------------------------
    def _replay_substrate(self, st: _ShardedStream
                          ) -> Tuple[SegmentQueryEngine, int, List[int]]:
        """Rebuild the stream's GLOBAL state on one full-width substrate
        engine: newest intact checkpoint (falling back across corrupt
        steps) + WAL-tail replay, dispatching on the shard tag (>= 0
        data, GC_SHARD, REBALANCE_SHARD). Returns (engine, last_seq,
        placement)."""
        applied = 0
        engine = None
        placement = compute_placement(st.shards, st.initial_hosts)
        if st.ckpt_dir is not None:
            _fault_point("ckpt_restore", st.name)
            try:
                engine, extra = SegmentQueryEngine.from_checkpoint(
                    st.ckpt_dir, return_meta=True, device=self.device)
                applied = int(extra.get("pool_applied_seq", 0))
                pl = extra.get("placement")
                if pl is not None:
                    placement = [int(x) for x in pl]
            except FileNotFoundError:
                pass                   # pre-first-snapshot: replay-only
        if engine is None:
            engine = self._new_engine(st)
        seq = applied
        if st.wal is not None:
            _fault_point("wal_replay", st.name)
            for rec in st.wal.replay(min_seq_exclusive=applied):
                if rec.shard == GC_SHARD:
                    engine.gc_apply([int(x) for x in rec.keys])
                elif rec.shard == REBALANCE_SHARD:
                    # the RECORDED re-partition, not a recomputation
                    placement = [int(x) for x in rec.keys]
                else:
                    engine.absorb(rec.keys, rec.weights, rec.active,
                                  shard=rec.shard)
                seq = rec.seq
        return engine, seq, placement

    def _rebuild_shards(self, st: _ShardedStream, shard_ids
                        ) -> Dict[int, Tuple[MultiSketch, bool]]:
        """Bit-exact slabs for shards whose owner died: full substrate
        replay (checkpoint + WAL tail), then extract the requested
        shards. Replaying EVERYTHING keeps adopted GC markers correct."""
        sub, _, _ = self._replay_substrate(st)
        return {int(s): (sub.shard_slab(int(s)), sub.shard_live(int(s)))
                for s in shard_ids}

    # -- ingest (fan-out to owner hosts) ------------------------------------
    def absorb(self, name: str, keys, weights, shard: int = 0
               ) -> AbsorbReceipt:
        """Ingest one chunk, routed to its shard's owner host: quarantine
        -> WAL append (fsync) -> owner fold with retries. A chunk whose
        owner is dead (or whose fold fails) is still DURABLE and counted
        in ``ingest_seq``; it waits in the pending backlog and queries
        show the exact lag until a rebalance (or the host's op
        succeeding) drains it. Backlog past ``pending_limit`` sheds with
        :class:`RejectedError` — the rejected chunk was never ack'd."""
        st = self._stream(name)
        if not (0 <= int(shard) < st.shards):
            raise ValueError(
                f"shard must be in [0, {st.shards}), got {shard}")
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
        applied = self._drain_pending(st)
        if applied:
            self._maybe_snapshot(st)
        return AbsorbReceipt(accepted, n_bad, applied=applied,
                             durable=st.wal is not None, seq=seq)

    def _drain_pending(self, st: _ShardedStream) -> bool:
        """Fold the backlog in sequence order onto owner hosts; True iff
        fully applied. Stops (without consuming) at the first chunk whose
        owner is dead — the WAL keeps it recoverable."""
        touched = set()
        while st.pending:
            seq, shard, k, w, act = st.pending[0]
            hid = st.placement[shard]
            # host-kill schedules fire here (deterministic op index)
            _fault_point("host_op", f"{st.name}@h{hid}")
            host = self._hosts.get(hid)
            if host is None or not host.alive:
                break
            try:
                self._retry(lambda: self._fold_one(st, host, shard,
                                                   k, w, act))
            except Exception:
                break
            st.pending.popleft()
            st.applied_seq = seq
            st.folds_since_snapshot += 1
            touched.add(hid)
        for hid in touched:
            eng = self._hosts[hid].engines.get(st.name)
            if eng is not None:
                # charge device work to the ingest path (zero-merge reads)
                eng.drain()
        return not st.pending

    def _fold_one(self, st: _ShardedStream, host: _Host, shard, k, w, act):
        _fault_point("absorb_fold", st.name)
        self._host_engine(st, host).absorb(k, w, act, shard=shard)

    def _retry(self, fn):
        return _retry_loop(fn, retries=self.retries,
                           backoff_base=self.backoff_base,
                           backoff_cap=self.backoff_cap,
                           rng=self._rng, sleep=self._sleep)

    # -- durability snapshots ------------------------------------------------
    def _maybe_snapshot(self, st: _ShardedStream):
        if (self.snapshot_every and st.ckpt_dir is not None
                and st.folds_since_snapshot >= self.snapshot_every):
            try:
                self.snapshot(st.name)
            except Exception:
                pass                   # WAL still covers everything

    def snapshot(self, name: str):
        """Checkpoint the stream's GLOBAL state: gather every live
        shard's slab from its owner onto a full-width substrate and save
        it stamping the applied sequence + placement, then prune the WAL
        to the oldest retained snapshot. Requires every shard's owner
        alive (rebalance first)."""
        st = self._stream(name)
        if st.ckpt_dir is None:
            raise ValueError(f"stream {name!r} is not durable")
        for s in range(st.shards):
            if not self._host_alive(st.placement[s]):
                raise HostDownError(
                    f"cannot snapshot {name!r}: owner host "
                    f"{st.placement[s]} of shard {s} is down")
        _fault_point("ckpt_save", name)
        sub = self._new_engine(st)
        for s in range(st.shards):
            eng = self._host_engine(st, self._hosts[st.placement[s]])
            if eng.shard_live(s):
                sub.set_shard(s, eng.shard_slab(s))
        sub.save_checkpoint(
            st.ckpt_dir,
            extra_meta={"pool_applied_seq": st.applied_seq,
                        "placement": [int(x) for x in st.placement]})
        st.folds_since_snapshot = 0
        st.snapshot_seqs.append(st.applied_seq)
        if (st.wal is not None
                and len(st.snapshot_seqs) >= self.keep_snapshots):
            st.wal.prune(st.snapshot_seqs[-self.keep_snapshots])

    # -- reads (cross-host merge + replica degradation) ----------------------
    def query(self, name: str, fs: Optional[Sequence[StatFn]] = None,
              predicates=EVERYTHING, timeout: Optional[float] = None
              ) -> Response:
        """Answer a segment-query batch from the global union: FRESH from
        one stacked re-selection over the live owners' merged slabs
        (memoized on placement + engine epochs), bit-identical to a
        single-host union engine; on failure the newest surviving replica
        serves at STALE with the exact chunk lag; REJECTED only when no
        replica survives."""
        st = self._stream(name)
        fs = (tuple(f for f, _ in st.spec.objectives) if fs is None
              else tuple(fs))
        table = np.asarray(encode_predicates(predicates), np.int32)
        deadline = (None if timeout is None
                    else self._clock() + timeout)
        # >= : timeout=0 (or an elapsed budget) sheds, never serves late
        if deadline is not None and self._clock() >= deadline:
            return Response(REJECTED, error="deadline")
        if st.pending:
            self._drain_pending(st)    # opportunistic catch-up
        err = None
        try:
            slab = self._retry(lambda: self._cross_merged(st))
            vals = multisketch_query_many(
                slab, fs, table, b_quantum=st.b_quantum,
                use_kernels=st.use_kernels)
            lag = st.ingest_seq - st.applied_seq
            self._replicate(st, slab)
            return Response(FRESH if lag == 0 else STALE, vals,
                            epoch_lag=lag,
                            overflow=bool(multisketch_overflow(slab)))
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
        rep = self._newest_replica(st)
        if rep is not None:
            rep_seq, slab = rep
            vals = multisketch_query_many(
                slab, fs, table, b_quantum=st.b_quantum,
                use_kernels=st.use_kernels)
            return Response(STALE, vals,
                            epoch_lag=st.ingest_seq - rep_seq,
                            overflow=bool(multisketch_overflow(slab)),
                            error=err)
        return Response(REJECTED, error=err or "no surviving replica")

    def _cross_merged(self, st: _ShardedStream) -> MultiSketch:
        """The global merged slab: stacked re-selection over every owner
        host's merged slab (``merge_host_slabs``). Raises
        :class:`HostDownError` when any owner is dead: a partial union
        would be silently WRONG, not stale."""
        _fault_point("query_merge", st.name)
        owners = sorted({st.placement[s] for s in range(st.shards)})
        for hid in owners:
            if not self._host_alive(hid):
                raise HostDownError(
                    f"host {hid} down (owns shards of {st.name!r})")
        key = (st.placement_version,
               tuple((hid, self._host_engine(st, self._hosts[hid]).epoch)
                     for hid in owners))
        if st.cross_cache is not None and st.cross_cache[0] == key:
            return st.cross_cache[1]
        slabs = [self._host_engine(st, self._hosts[hid]).merged
                 for hid in owners]
        merged = merge_host_slabs(st.spec, slabs,
                                  use_kernels=st.use_kernels)
        st.cross_merges += 1
        st.cross_cache = (key, merged)
        return merged

    def _replica_hosts(self, st: _ShardedStream) -> List[int]:
        """Primary + one FOLLOWER for the stream's last-good slab —
        rendezvous-ranked over the live hosts by stream name."""
        ranked = sorted(
            self.live_hosts,
            key=lambda h: zlib.crc32(f"{st.name}@{h}".encode()),
            reverse=True)
        return ranked[:2]

    def _replicate(self, st: _ShardedStream, slab: MultiSketch):
        for hid in self._replica_hosts(st):
            self._hosts[hid].replicas[st.name] = (st.applied_seq, slab)

    def _newest_replica(self, st: _ShardedStream
                        ) -> Optional[Tuple[int, MultiSketch]]:
        best = None
        for h in self._hosts.values():
            if h.alive and st.name in h.replicas:
                seq, slab = h.replicas[st.name]
                if best is None or seq > best[0]:
                    best = (seq, slab)
        return best

    # -- membership change (rebalance + REBALANCE marker) --------------------
    def rebalance(self, name: Optional[str] = None,
                  exclude: Sequence[int] = ()) -> Dict[str, dict]:
        """Re-partition stream shards over the current live hosts (minus
        ``exclude``), per stream: live->live moves are slab hand-offs;
        shards stranded on a DEAD host are rebuilt bit-exactly from
        checkpoint + WAL tail. Each changed stream then appends a
        REBALANCE marker recording the new placement (apply-then-append)."""
        names = [name] if name is not None else sorted(self._streams)
        return {nm: self._rebalance_stream(self._streams[nm], exclude)
                for nm in names}

    def _rebalance_stream(self, st: _ShardedStream,
                          exclude: Sequence[int]) -> dict:
        targets = [h for h in self.live_hosts if h not in set(exclude)]
        if not targets:
            raise RuntimeError("no live hosts to rebalance onto")
        new_place = compute_placement(st.shards, targets)
        moved = {s: (st.placement[s], new_place[s])
                 for s in range(st.shards)
                 if st.placement[s] != new_place[s]}
        if not moved:
            return {"moved": {}, "placement": tuple(st.placement),
                    "marker_seq": None, "error": None}
        dead_src = sorted({s for s, (o, _) in moved.items()
                           if not self._host_alive(o)})
        rebuilt = self._rebuild_shards(st, dead_src) if dead_src else {}
        for s, (o, n) in sorted(moved.items()):
            teng = self._host_engine(st, self._hosts[n])
            if s in rebuilt:
                slab, live = rebuilt[s]
                if live:
                    teng.set_shard(s, slab)
            else:
                seng = self._host_engine(st, self._hosts[o])
                if seng.shard_live(s):
                    teng.set_shard(s, seng.shard_slab(s))
                seng.clear_shard(s)
        st.placement = list(new_place)
        st.placement_version += 1
        st.cross_cache = None
        if dead_src:
            # the rebuild REPLAYED every WAL'd record of those shards —
            # pending entries for them are already in the new owner's slab
            covered = set(dead_src)
            st.pending = deque(p for p in st.pending
                               if p[1] not in covered)
            st.applied_seq = (st.pending[0][0] - 1 if st.pending
                              else st.ingest_seq)
        self._drain_pending(st)
        err = None
        marker_seq = st.ingest_seq + 1
        if st.wal is not None:
            try:
                _fault_point("wal_append", st.name)
                st.wal.append(marker_seq, REBALANCE_SHARD,
                              np.asarray(new_place, np.int32),
                              np.zeros(st.shards, np.float32),
                              np.ones(st.shards, np.uint8))
            except Exception as e:
                # moves applied but the marker is lost: recovery replays
                # the pre-move placement — same union, identical answers
                err = (f"rebalance marker not durable: "
                       f"{type(e).__name__}: {e}")
        st.ingest_seq = marker_seq
        if not st.pending:
            st.applied_seq = marker_seq
        return {"moved": moved, "placement": tuple(new_place),
                "marker_seq": marker_seq, "error": err}

    # -- health --------------------------------------------------------------
    def _stream(self, name: str) -> _ShardedStream:
        try:
            return self._streams[name]
        except KeyError:
            raise KeyError(f"unknown stream {name!r}") from None

    @property
    def streams(self):
        return tuple(self._streams)

    def placement(self, name: str) -> Tuple[int, ...]:
        return tuple(self._stream(name).placement)

    def stats(self, name: str) -> dict:
        """Health snapshot of one stream: sequence frontier, placement,
        owner liveness, cross-merge accounting."""
        st = self._stream(name)
        owners = sorted({st.placement[s] for s in range(st.shards)})
        return {"ingest_seq": st.ingest_seq,
                "applied_seq": st.applied_seq,
                "epoch_lag": st.ingest_seq - st.applied_seq,
                "pending": len(st.pending),
                "quarantined": st.quarantined,
                "placement": tuple(st.placement),
                "placement_version": st.placement_version,
                "owners": tuple(owners),
                "owners_alive": all(self._host_alive(h) for h in owners),
                "cross_merges": st.cross_merges,
                "replica_hosts": tuple(self._replica_hosts(st))
                if self.live_hosts else ()}

    def host_stats(self) -> Dict[int, dict]:
        """Per-host gauges under the engine's ``merge_stats`` wire names
        (summed over the host's resident engines), plus ownership and
        replica counts — the scale-out rows telemetry exports next to the
        stream stats (``telemetry.stats.collect_host_gauges``)."""
        out: Dict[int, dict] = {}
        for hid in sorted(self._hosts):
            h = self._hosts[hid]
            row = {"alive": h.alive, "streams": len(h.engines),
                   "replica_streams": len(h.replicas),
                   "owned_shards": sum(
                       1 for st in self._streams.values()
                       for s in range(st.shards)
                       if st.placement[s] == hid),
                   "live_shards": 0, "bytes_resident": 0, "gc_merges": 0}
            for eng in h.engines.values():
                row["live_shards"] += eng.merge_stats["live_shards"]
                row["bytes_resident"] += eng.merge_stats["bytes_resident"]
                row["gc_merges"] += eng.merge_stats["gc_merges"]
            out[hid] = row
        return out
