"""The port's ``EnginePool`` (``repro_torch.launch.pool``) under the serving
contract of tests/test_serving_faults.py: shedding, deadlines, coalescing ==
direct (bitwise), per-row quarantine, retry/backoff, the breaker and the
FRESH -> STALE -> REJECTED ladder, crash recovery bit-identical, and WAL
and checkpoint files carried between the two packages. The chaos harness
tests/faults.py is reused unchanged by pointing its ``pool_mod`` at the
port's pool."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as C                                        # noqa: E402
import repro_torch.core as T                                  # noqa: E402
import repro_torch.launch.pool as pool_mod                    # noqa: E402
from repro.launch.pool import EnginePool as RefPool           # noqa: E402
from repro.launch.wal import WriteAheadLog as RefWal          # noqa: E402
from repro_torch.launch.pool import (FRESH, REJECTED, STALE,  # noqa: E402
                                     CircuitBreaker, EnginePool,
                                     RejectedError)
from repro_torch.launch.query import SegmentQueryEngine       # noqa: E402
from repro_torch.launch.wal import GC_SHARD, WriteAheadLog    # noqa: E402
from tests import faults                                      # noqa: E402
from tests.faults import (FaultInjected, FaultInjector,       # noqa: E402
                          corrupt_checkpoint, tear_wal)
from tests.torch_parity import (EST_RTOL, assert_slab_parity,  # noqa: E402
                                assert_slabs_bitsame)


@pytest.fixture(autouse=True)
def _port_fault_points(monkeypatch):
    monkeypatch.setattr(faults, "pool_mod", pool_mod)
    yield
    pool_mod.clear_fault_hooks()


def _spec(seed=0):
    return T.MultiSketchSpec(objectives=((T.SUM, 16), (T.COUNT, 8),
                                         (T.thresh(2.0), 12)), seed=seed)


def _ref_spec(seed=0):
    return C.MultiSketchSpec(objectives=((C.SUM, 16), (C.COUNT, 8),
                                         (C.thresh(2.0), 12)), seed=seed)


def _chunks(n_chunks=6, n=160, seed=3):
    rng = np.random.default_rng(seed)
    return [((i * n + np.arange(n)).astype(np.int32),
             rng.lognormal(0, 1.5, n).astype(np.float32))
            for i in range(n_chunks)]


def _pool(**kw):
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("backoff_base", 1e-4)
    kw.setdefault("device", "cpu")
    return EnginePool(**kw)


def _engine(spec, **kw):
    return SegmentQueryEngine(spec, device="cpu", **kw)


# ------------------------------------------------------------- admission
def test_queue_full_sheds_and_backlog_bound_sheds_ingest():
    pool = _pool(queue_depth=4)
    pool.create_stream("t", _spec())
    futs = [pool.submit("t") for _ in range(4)]
    with pytest.raises(RejectedError):
        pool.submit("t")
    assert pool.pump() == 4
    assert all(f.result(1.0).status == FRESH for f in futs)
    pool2 = _pool(pending_limit=3, retries=0, breaker_threshold=1,
                  breaker_reset=1e9)
    pool2.create_stream("t", _spec())
    ch = _chunks(4)
    with FaultInjector() as inj:
        inj.fail_always("absorb_fold")
        for keys, w in ch[:3]:
            pool2.absorb("t", keys, w)
        with pytest.raises(RejectedError):
            pool2.absorb("t", *ch[3])
    assert pool2.stats("t")["pending"] == 3
    with pytest.raises(ValueError):
        pool2.absorb("t", *ch[0], shard=-1)
    with pytest.raises(KeyError):
        pool2.query("nope")


def test_deadlines_shed_under_a_frozen_clock():
    t = [0.0]
    pool = _pool(clock=lambda: t[0])
    pool.create_stream("t", _spec())
    pool.absorb("t", *_chunks(1)[0])
    fut = pool.submit("t", timeout=0.5)
    t[0] = 1.0
    pool.pump()
    r = fut.result(1.0)
    assert r.status == REJECTED and r.error == "deadline" and r.values is None
    assert pool.query("t", timeout=0).status == REJECTED
    assert pool.gc("t", timeout=0).status == REJECTED
    assert pool.query("t", timeout=5.0).status == FRESH


def test_coalesced_answers_equal_direct_bitwise(monkeypatch):
    pool = _pool()
    eng = pool.create_stream("t", _spec())
    pool.absorb("t", *_chunks(1)[0])
    preds = [T.key_range(i * 20, i * 20 + 19) for i in range(6)]
    preds += [T.hash_fraction(0.5, 3), T.key_mask(1, 0)]
    direct = [eng.query_many(predicates=[p]) for p in preds]
    want = eng.query_many(predicates=preds)
    calls = []
    orig = SegmentQueryEngine.query_many

    def spy(self, fs=None, predicates=T.EVERYTHING):
        calls.append(np.asarray(predicates).shape[0])
        return orig(self, fs, predicates)
    monkeypatch.setattr(SegmentQueryEngine, "query_many", spy)
    futs = [pool.submit("t", predicates=p) for p in preds]
    pool.pump()
    assert calls == [len(preds)]
    got = np.concatenate([f.result(1.0).values for f in futs], axis=1)
    np.testing.assert_array_equal(got, want)
    # one predicate's bits do not depend on the batch it rode in
    np.testing.assert_array_equal(got, np.concatenate(direct, axis=1))


def test_one_bad_producer_cannot_poison_a_tenant_slab():
    pool = _pool()
    spec = _spec()
    eng = pool.create_stream("t", spec)
    keys, w = _chunks(1)[0]
    bad_w = w.copy()
    bad_w[::7] = np.nan
    bad_w[3::7] = -1.0
    receipt = pool.absorb("t", keys, bad_w)
    n_bad = int(np.isnan(bad_w).sum() + (bad_w < 0).sum())
    assert receipt.quarantined == n_bad == pool.stats("t")["quarantined"]
    clean = ~(np.isnan(bad_w) | (bad_w < 0))
    twin = _engine(spec)
    twin.absorb(np.where(clean, keys, -1),
                np.where(clean, bad_w, 0).astype(np.float32), clean)
    assert_slabs_bitsame(eng.merged, twin.merged)
    r = pool.absorb("t", np.arange(4), np.full(4, np.nan))
    assert r.accepted == 0 and r.quarantined == 4


# ---------------------------------------------- retries, breaker, ladder
def test_retry_backoff_and_breaker():
    delays = []
    pool = EnginePool(retries=3, backoff_base=0.01, backoff_cap=10.0,
                      sleep=delays.append, device="cpu")
    pool.create_stream("t", _spec())
    with FaultInjector() as inj:
        inj.fail_next("absorb_fold", 3)
        assert pool.absorb("t", *_chunks(1)[0]).applied
    assert len(delays) == 3
    for i, d in enumerate(delays):
        assert 0.01 * 2 ** i * 0.5 <= d <= 0.01 * 2 ** i * 1.5
    t = [0.0]
    br = CircuitBreaker(threshold=2, reset_after=1.0, clock=lambda: t[0])
    br.record_failure()
    br.record_failure()
    assert br.is_open and not br.allow() and br.open_count == 1
    t[0] = 1.5
    assert br.allow()
    br.record_success()
    assert not br.is_open


def test_ladder_fresh_stale_rejected_and_recovery():
    t = [0.0]
    pool = _pool(retries=1, breaker_threshold=1, breaker_reset=1.0,
                 clock=lambda: t[0])
    pool.create_stream("t", _spec())
    ch = _chunks(3)
    pool.absorb("t", *ch[0])
    fresh = pool.query("t")
    assert fresh.status == FRESH and fresh.epoch_lag == 0
    with FaultInjector() as inj:
        inj.fail_always("query_merge")
        r2 = pool.query("t")
        assert r2.status == STALE and r2.error is not None
        np.testing.assert_array_equal(r2.values, fresh.values)
        pool.absorb("t", *ch[1])
        pool.absorb("t", *ch[2])
        r3 = pool.query("t")
        assert r3.status == STALE and r3.epoch_lag == 2
        np.testing.assert_array_equal(r3.values, fresh.values)
        inj.heal("query_merge")
        t[0] = 2.0                          # half-open probe succeeds, but
        r4 = pool.query("t")                # the fold backlog still waits
        assert r4.status == STALE and r4.epoch_lag == 2
        pool.absorb("t", *_chunks(4)[3])    # drains the backlog in order
        r5 = pool.query("t")
        assert r5.status == FRESH and r5.epoch_lag == 0
    pool2 = _pool(retries=0, breaker_threshold=1, breaker_reset=1e9)
    pool2.create_stream("u", _spec())
    pool2.absorb("u", *ch[0])
    with FaultInjector() as inj:
        inj.fail_always("query_merge")
        r6 = pool2.query("u")
    assert r6.status == REJECTED and r6.values is None


def test_failed_fold_is_stale_with_lag_then_replays_in_order():
    pool = _pool(retries=0, breaker_threshold=1, breaker_reset=0.0)
    spec = _spec()
    eng = pool.create_stream("t", spec)
    ch = _chunks(4)
    pool.absorb("t", *ch[0])
    assert pool.query("t").status == FRESH
    with FaultInjector() as inj:
        inj.fail_next("absorb_fold", 2)
        assert not pool.absorb("t", *ch[1]).applied
        r = pool.query("t")
        assert r.status == STALE and r.epoch_lag == 1
        pool.absorb("t", *ch[2])
        pool.absorb("t", *ch[3])
    assert pool.stats("t")["epoch_lag"] == 0
    twin = _engine(spec)
    for keys, w in ch:
        twin.absorb(keys, w)
    assert_slabs_bitsame(eng.merged, twin.merged)


def test_overflow_flag_and_admin_gc_labels():
    spec = T.MultiSketchSpec(objectives=((T.SUM, 16), (T.COUNT, 8)),
                             capacity=8)
    pool = _pool()
    pool.create_stream("small", spec)
    pool.absorb("small", *_chunks(1, n=256)[0])
    assert pool.query("small").overflow
    pool.create_stream("t", _spec(), shards=3)
    for i, (k, w) in enumerate(_chunks(3)):
        pool.absorb("t", k, w, shard=i)
    before = pool.query("t").values
    fut = pool.request_gc("t", max_live=1)
    q = pool.submit("t")
    pool.pump()                           # queries first, then the admin op
    assert q.result(1.0).status == FRESH
    g = fut.result(1.0)
    assert g.status == FRESH and g.gc_epoch and g.gc_victims == (1, 2)
    after = pool.query("t")
    assert after.gc_epoch
    np.testing.assert_array_equal(after.values, before)


def test_background_worker_serves_submissions():
    pool = _pool()
    pool.create_stream("t", _spec())
    pool.absorb("t", *_chunks(1)[0])
    want = pool.query("t").values
    pool.start(interval=0.001)
    try:
        got = [f.result(5.0) for f in [pool.submit("t") for _ in range(6)]]
    finally:
        pool.stop()
    for r in got:
        assert r.status == FRESH
        np.testing.assert_array_equal(r.values, want)


# ----------------------------------------------------------- durability
def _durable_run(d, chunks, **kw):
    pool = _pool(durability_dir=d, **kw)
    eng = pool.create_stream("t", _spec(seed=7), shards=2)
    for i, (keys, w) in enumerate(chunks):
        pool.absorb("t", keys, w, shard=i % 2)
    live = eng.merged
    pool.close()
    return live


@pytest.mark.parametrize("damage", ["none", "corrupt_newest_ckpt",
                                    "torn_wal", "no_snapshot", "gc_marker"])
def test_crash_recovery_bit_identical(tmp_path, damage):
    d = str(tmp_path / "pool")
    chunks = _chunks(10)
    if damage == "gc_marker":
        pool = _pool(durability_dir=d, snapshot_every=4)
        eng = pool.create_stream("t", _spec(seed=7), shards=3)
        for i, (keys, w) in enumerate(chunks[:6]):
            pool.absorb("t", keys, w, shard=i % 3)
        assert pool.compact("t").gc_victims == (1, 2)
        pool.absorb("t", *chunks[6], shard=1)
        live, layout = eng.merged, eng.num_shards
        pool.close()
        got = EnginePool.open(d, device="cpu")._streams["t"].engine
        assert got.num_shards == layout and not got.shard_live(2)
        assert_slabs_bitsame(got.merged, live)
        return
    live = _durable_run(d, chunks,
                        snapshot_every=0 if damage == "no_snapshot" else 4)
    if damage == "corrupt_newest_ckpt":
        corrupt_checkpoint(os.path.join(d, "t", "ckpt"), "flip_byte")
    if damage == "torn_wal":
        tear_wal(os.path.join(d, "t", "wal.log"), 11)
    pool2 = EnginePool.open(d, device="cpu")
    st = pool2.stats("t")
    want_seq = 9 if damage == "torn_wal" else 10
    assert st["ingest_seq"] == st["applied_seq"] == want_seq
    got = pool2._streams["t"].engine.merged
    if damage == "torn_wal":
        twin = _engine(_spec(seed=7), shards=2)
        for i, (keys, w) in enumerate(chunks[:9]):
            twin.absorb(keys, w, shard=i % 2)
        live = twin.merged
    assert_slabs_bitsame(got, live)
    assert pool2.query("t").status == FRESH


def test_snapshot_failure_degrades_without_data_loss(tmp_path):
    d = str(tmp_path / "pool")
    pool = _pool(durability_dir=d, snapshot_every=2)
    eng = pool.create_stream("t", _spec())
    with FaultInjector() as inj:
        inj.fail_always("ckpt_save")
        for keys, w in _chunks(4):
            pool.absorb("t", keys, w)
        assert inj.fired["ckpt_save"] >= 1
    assert pool.stats("t")["snapshot_failures"] >= 1
    live = eng.merged
    pool.close()
    assert_slabs_bitsame(
        EnginePool.open(d, device="cpu")._streams["t"].engine.merged, live)


def test_injected_faults_are_the_harness_exception():
    pool = _pool(retries=0, breaker_threshold=5)
    pool.create_stream("t", _spec())
    with FaultInjector() as inj:
        inj.fail_next("absorb_fold", 1, exc=FaultInjected)
        assert not pool.absorb("t", *_chunks(1)[0]).applied
        assert inj.fired["absorb_fold"] == 1


# ------------------------------------------------------- across packages
def _wal_records(rng, n_rec=5, rows=32):
    recs = []
    for seq in range(1, n_rec + 1):
        recs.append((seq, seq % 3, rng.integers(0, 1 << 20, rows).astype(
            np.int32), rng.random(rows).astype(np.float32),
            rng.random(rows) < 0.9))
    recs.append((n_rec + 1, GC_SHARD, np.array([1, 2], np.int32),
                 np.zeros(2, np.float32), np.ones(2, bool)))
    return recs


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_wal_files_are_byte_identical_and_replay_across(tmp_path, writer):
    recs = _wal_records(np.random.default_rng(1))
    paths = {}
    for name, cls in (("reference", RefWal), ("port", WriteAheadLog)):
        paths[name] = str(tmp_path / f"{name}.log")
        wal = cls(paths[name])
        for r in recs:
            wal.append(*r)
        wal.close()
    with open(paths["reference"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    reader = WriteAheadLog if writer == "reference" else RefWal
    got = list(reader(paths[writer]).replay())
    assert [r.seq for r in got] == [r[0] for r in recs]
    for g, (seq, shard, k, w, a) in zip(got, recs):
        assert g.shard == shard
        np.testing.assert_array_equal(g.keys, k)
        np.testing.assert_array_equal(g.weights, w)
        np.testing.assert_array_equal(g.active, a)
    tear_wal(paths[writer], drop_bytes=5)
    assert len(list(reader(paths[writer]).replay())) == len(recs) - 1


def test_reference_pool_directory_recovers_in_port(tmp_path):
    """A durable reference pool (stream.json, checkpoints, WAL tail) opens
    in the port; its answers match the reference's own recovery."""
    d = str(tmp_path / "pool")
    ref = RefPool(durability_dir=d, snapshot_every=3, sleep=lambda s: None)
    ref.create_stream("t", _ref_spec(seed=4), shards=2)
    for i, (keys, w) in enumerate(_chunks(7)):
        ref.absorb("t", keys, w, shard=i % 2)
    ref.close()
    table = C.encode_predicates([C.EVERYTHING, C.key_range(100, 600),
                                 C.hash_fraction(0.5, 1)])
    want = RefPool.open(d, sleep=lambda s: None).query("t", predicates=table)
    port = EnginePool.open(d, device="cpu")
    assert port.stats("t")["applied_seq"] == 7
    got = port.query("t", predicates=table)
    assert got.status == want.status == FRESH
    np.testing.assert_allclose(got.values, want.values, rtol=EST_RTOL)
    # shards restored from the checkpoint, then folded on by each package
    ref_eng = RefPool.open(d, sleep=lambda s: None)._streams["t"].engine
    for i in range(2):
        assert_slab_parity(ref_eng.shard_slab(i),
                           port._streams["t"].engine.shard_slab(i))
