"""The port's scale-out tier (``repro_torch.launch.pool.ShardedEnginePool``)
under the contract of tests/test_pool_scaleout.py, with its telemetry
(``repro_torch.telemetry.stats``) and the pieces it rests on
(``launch.summary.merge_host_slabs``, ``SegmentQueryEngine.load_stacked``,
``core.multi_sketch.multisketch_estimate``).

Two kinds of comparison:
  * within the port, a FRESH answer is bit-equal to a single-host port
    ``SegmentQueryEngine`` twin over the same chunks, including after a
    kill, a rebalance, a join/leave and a reopen;
  * against the reference, the same numpy chunks go through the JAX
    package's pool and the port's: placements identical, merged slabs and
    answers within tests/torch_parity.py's bounds.
The chaos harness tests/faults.py is reused unchanged by pointing its
``pool_mod`` at the port's pool. Everything runs on the CPU
(``device="cpu"``)."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as C                                        # noqa: E402
import repro_torch.core as T                                  # noqa: E402
import repro_torch.launch.pool as pool_mod                    # noqa: E402
from repro.launch.pool import ShardedEnginePool as RefPool    # noqa: E402
from repro.launch.pool import compute_placement as ref_placement  # noqa
from repro.launch.query import SegmentQueryEngine as RefEngine  # noqa
from repro.launch.summary import merge_host_slabs as ref_merge  # noqa
from repro.telemetry import stats as RS                       # noqa: E402
from repro_torch.launch.pool import (FRESH, REJECTED, STALE,  # noqa: E402
                                     HostDownError, RejectedError,
                                     ShardedEnginePool, compute_placement,
                                     rendezvous_owner)
from repro_torch.launch.query import SegmentQueryEngine       # noqa: E402
from repro_torch.launch.summary import merge_host_slabs       # noqa: E402
from repro_torch.launch.wal import REBALANCE_SHARD            # noqa: E402
from repro_torch.telemetry import stats as TS                 # noqa: E402
from tests import faults                                      # noqa: E402
from tests.faults import FaultInjector, tear_wal              # noqa: E402
from tests.torch_parity import (EST_RTOL, assert_slab_parity,  # noqa: E402
                                assert_slabs_bitsame, to_np)

HOSTS = (0, 1, 2, 3)
SHARDS = 16


@pytest.fixture(autouse=True)
def _port_fault_points(monkeypatch):
    monkeypatch.setattr(faults, "pool_mod", pool_mod)
    yield
    pool_mod.clear_fault_hooks()


def _spec(seed=0):
    return T.MultiSketchSpec(objectives=((T.SUM, 16), (T.COUNT, 8)),
                             seed=seed, capacity=128)


def _ref_spec(seed=0):
    return C.MultiSketchSpec(objectives=((C.SUM, 16), (C.COUNT, 8)),
                             seed=seed, capacity=128)


def _chunks(n_chunks=18, n=60, seed=3, shards=SHARDS):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_chunks):
        keys = (i * n + np.arange(n)).astype(np.int32)
        w = rng.lognormal(0, 1.5, n).astype(np.float32)
        out.append((int(rng.integers(0, shards)), keys, w))
    return out


def _fast_pool(**kw):
    kw.setdefault("hosts", HOSTS)
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("backoff_base", 1e-4)
    kw.setdefault("device", "cpu")
    return ShardedEnginePool(**kw)


def _open(path):
    return ShardedEnginePool.open(str(path), sleep=lambda s: None,
                                  device="cpu")


def _twin(chunks, spec=None, shards=SHARDS):
    """The never-failed single-host union oracle, in the port."""
    eng = SegmentQueryEngine(spec or _spec(), shards=shards, device="cpu")
    for sh, k, w in chunks:
        eng.absorb(k, w, shard=sh)
    return eng


def _feed(pool, chunks, name="t"):
    for sh, k, w in chunks:
        pool.absorb(name, k, w, shard=sh)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def test_rendezvous_placement_is_deterministic_and_total():
    p1 = compute_placement(SHARDS, HOSTS)
    p2 = compute_placement(SHARDS, list(reversed(HOSTS)))
    assert p1 == p2                        # order-free
    assert set(p1) == set(HOSTS)           # every host owns something
    assert rendezvous_owner(0, (5,)) == 5
    with pytest.raises(ValueError):
        rendezvous_owner(0, ())


def test_rendezvous_movement_is_minimal_under_membership_change():
    base = compute_placement(64, HOSTS)
    down = compute_placement(64, (0, 1, 3))
    moved = [s for s in range(64) if base[s] != down[s]]
    assert moved and all(base[s] == 2 for s in moved)
    up = compute_placement(64, HOSTS + (4,))
    moved = [s for s in range(64) if base[s] != up[s]]
    assert moved and all(up[s] == 4 for s in moved)


@pytest.mark.parametrize("shards,hosts", [(16, HOSTS), (64, (0, 1, 3)),
                                          (64, HOSTS + (4,)), (7, (9,)),
                                          (33, (2, 5, 11, 40, 41))])
def test_placement_equals_reference(shards, hosts):
    assert compute_placement(shards, hosts) == ref_placement(shards, hosts)


def test_absorb_fans_out_to_owner_hosts_only():
    pool = _fast_pool()
    placement = pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks(10)
    _feed(pool, chunks)
    touched = {sh for sh, _, _ in chunks}
    for hid in HOSTS:
        eng = pool._hosts[hid].engines.get("t")
        owned = {s for s in touched if placement[s] == hid}
        if eng is None:
            assert not owned
            continue
        for s in range(SHARDS):
            assert eng.shard_live(s) == (s in owned)


# ---------------------------------------------------------------------------
# cross-host reads: exactness + caching
# ---------------------------------------------------------------------------

def test_query_bit_identical_to_single_host_union_engine():
    pool = _fast_pool()
    pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks()
    _feed(pool, chunks)
    twin = _twin(chunks)
    r = pool.query("t")
    assert r.status == FRESH and r.epoch_lag == 0
    np.testing.assert_array_equal(r.values, twin.query_many())
    assert_slabs_bitsame(pool._cross_merged(pool._stream("t")), twin.merged)
    preds = [T.key_range(0, 300), T.key_range(301, 10**6)]
    r2 = pool.query("t", predicates=preds)
    np.testing.assert_array_equal(r2.values,
                                  twin.query_many(predicates=preds))


def test_cross_host_merge_is_memoized_per_epoch():
    pool = _fast_pool()
    pool.create_stream("t", _spec(), shards=SHARDS)
    _feed(pool, _chunks(6))
    pool.query("t")
    st = pool._stream("t")
    merges = st.cross_merges
    assert merges >= 1
    for _ in range(5):
        assert pool.query("t").status == FRESH
    assert st.cross_merges == merges       # steady-state reads: zero merges
    sh, k, w = _chunks(1, seed=99)[0]
    pool.absorb("t", k, w, shard=sh)
    pool.query("t")
    assert st.cross_merges == merges + 1   # one re-selection per new epoch


def test_query_timeout_zero_is_rejected():
    t = [5.0]
    pool = _fast_pool(clock=lambda: t[0])
    pool.create_stream("t", _spec(), shards=4)
    r = pool.query("t", timeout=0)
    assert r.status == REJECTED and r.error == "deadline"
    assert pool.query("t", timeout=10.0).status == FRESH


# ---------------------------------------------------------------------------
# host loss: replica reads, pending backlog, follower promotion
# ---------------------------------------------------------------------------

def test_host_kill_serves_stale_from_replica_with_exact_lag():
    pool = _fast_pool()
    pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks()
    _feed(pool, chunks)
    good = pool.query("t")
    assert good.status == FRESH
    pool.kill_host(HOSTS[0])
    r = pool.query("t")
    assert r.status == STALE and r.error is not None
    np.testing.assert_array_equal(r.values, good.values)
    extra = _chunks(3, seed=11)
    for sh, k, w in extra:
        rec = pool.absorb("t", k, w, shard=sh)
        assert rec.seq > 0
    r2 = pool.query("t")
    assert r2.status == STALE and r2.epoch_lag >= len(extra)


def test_follower_promotion_survives_primary_replica_host_loss():
    pool = _fast_pool()
    pool.create_stream("t", _spec(), shards=SHARDS)
    _feed(pool, _chunks())
    good = pool.query("t")
    st = pool._stream("t")
    primary, follower = pool._replica_hosts(st)
    pool.kill_host(primary)               # replica + owned shards gone
    r = pool.query("t")
    assert r.status == STALE
    np.testing.assert_array_equal(r.values, good.values)
    assert st.name in pool._hosts[follower].replicas
    pool.kill_host(follower)              # every replica gone: REJECTED
    r2 = pool.query("t")
    assert r2.status == REJECTED and r2.values is None
    assert r2.error is not None


def test_dead_owner_absorbs_stay_pending_durable_and_shed_at_limit(tmp_path):
    pool = _fast_pool(durability_dir=str(tmp_path), pending_limit=4)
    placement = pool.create_stream("t", _spec(), shards=SHARDS)
    _feed(pool, _chunks(4))
    victim = placement[0]
    pool.kill_host(victim)
    dead_shard = placement.index(victim)
    k, w = np.arange(50, dtype=np.int32) + 10**6, np.ones(50, np.float32)
    for i in range(4):
        rec = pool.absorb("t", k + i * 50, w, shard=dead_shard)
        assert rec.durable and not rec.applied
    with pytest.raises(RejectedError):
        pool.absorb("t", k + 999, w, shard=dead_shard)
    s = pool.stats("t")
    assert s["pending"] == 4 and s["epoch_lag"] == 4
    assert not s["owners_alive"]
    pool.close()


def test_fault_injector_kill_schedule_fires_at_exact_op_index():
    pool = _fast_pool()
    pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks(8)
    with FaultInjector() as inj:
        inj.kill_host(pool, HOSTS[1], at=5)
        for sh, k, w in chunks:
            pool.absorb("t", k, w, shard=sh)
            if inj.calls.get("host_op", 0) <= 5:
                assert pool._hosts[HOSTS[1]].alive
        assert inj.fired["host_op"] == 1
    assert not pool._hosts[HOSTS[1]].alive


# ---------------------------------------------------------------------------
# rebalance: hand-off, dead-host rebuild, REBALANCE marker
# ---------------------------------------------------------------------------

def test_rebalance_after_kill_rebuilds_bit_identically(tmp_path):
    pool = _fast_pool(durability_dir=str(tmp_path))
    placement = pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks()
    _feed(pool, chunks)
    victim = placement[0]
    pool.kill_host(victim)
    extra = _chunks(4, seed=21)           # some land pending on the dead host
    for sh, k, w in extra:
        pool.absorb("t", k, w, shard=sh)
    out = pool.rebalance("t")["t"]
    assert out["error"] is None and out["moved"]
    assert all(o == victim for s, (o, n) in out["moved"].items())
    assert victim not in out["placement"]
    r = pool.query("t")
    twin = _twin(chunks + extra)
    assert r.status == FRESH and r.epoch_lag == 0
    np.testing.assert_array_equal(r.values, twin.query_many())
    recs = [rec for rec in pool._stream("t").wal.replay()
            if rec.shard == REBALANCE_SHARD]
    assert len(recs) == 1
    assert tuple(int(x) for x in recs[0].keys) == out["placement"]
    pool.close()


def test_live_handoff_on_join_and_leave_is_bit_identical(tmp_path):
    pool = _fast_pool(durability_dir=str(tmp_path))
    pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks()
    _feed(pool, chunks)
    twin = _twin(chunks)
    pool.host_join(9)
    out = pool.rebalance("t")["t"]
    assert out["moved"] and all(n == 9 for s, (o, n) in out["moved"].items())
    r = pool.query("t")
    assert r.status == FRESH
    np.testing.assert_array_equal(r.values, twin.query_many())
    pool.host_leave(9)
    assert 9 not in pool.hosts
    assert 9 not in pool.placement("t")
    r2 = pool.query("t")
    assert r2.status == FRESH
    np.testing.assert_array_equal(r2.values, twin.query_many())
    pool.close()


def test_recovery_replays_rebalance_marker_to_identical_layout(tmp_path):
    pool = _fast_pool(durability_dir=str(tmp_path))
    placement = pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks()
    _feed(pool, chunks)
    pool.kill_host(placement[0])
    out = pool.rebalance("t")["t"]
    after = _chunks(3, seed=31)           # post-move records in the WAL
    for sh, k, w in after:
        pool.absorb("t", k, w, shard=sh)
    pool.close()
    pool2 = _open(tmp_path)
    assert pool2.placement("t") == out["placement"]
    twin = _twin(chunks + after)
    r = pool2.query("t")
    assert r.status == FRESH
    np.testing.assert_array_equal(r.values, twin.query_many())
    st = pool2._stream("t")
    for s in range(SHARDS):
        eng = pool2._hosts[st.placement[s]].engines.get("t")
        if eng is not None and eng.shard_live(s):
            assert_slabs_bitsame(eng.shard_slab(s), twin.shard_slab(s),
                                 f"shard {s} ")
    pool2.close()


def test_lost_rebalance_marker_recovers_pre_move_placement(tmp_path):
    pool = _fast_pool(durability_dir=str(tmp_path))
    placement = pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks()
    _feed(pool, chunks)
    twin = _twin(chunks)
    with FaultInjector() as inj:
        inj.fail_next("wal_append", 1)
        out = pool.rebalance("t", exclude=(placement[0],))["t"]
    assert out["moved"]
    assert out["error"] and "marker" in out["error"]
    pool.close()
    pool2 = _open(tmp_path)
    assert pool2.placement("t") == tuple(placement)   # pre-move layout
    r = pool2.query("t")
    assert r.status == FRESH
    np.testing.assert_array_equal(r.values, twin.query_many())
    pool2.close()


def test_torn_rebalance_marker_recovers_pre_move_placement(tmp_path):
    pool = _fast_pool(durability_dir=str(tmp_path))
    placement = pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks()
    _feed(pool, chunks)
    twin = _twin(chunks)
    out = pool.rebalance("t", exclude=(placement[0],))["t"]
    assert out["moved"] and out["error"] is None
    pool.close()
    tear_wal(str(tmp_path / "t" / "wal.log"), drop_bytes=7)
    pool2 = _open(tmp_path)
    assert pool2.placement("t") == tuple(placement)
    r = pool2.query("t")
    assert r.status == FRESH
    np.testing.assert_array_equal(r.values, twin.query_many())
    pool2.close()


def test_snapshot_plus_wal_tail_recovery_is_bit_identical(tmp_path):
    pool = _fast_pool(durability_dir=str(tmp_path), snapshot_every=5,
                      keep_snapshots=2)
    pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks(17)
    _feed(pool, chunks)
    assert pool._stream("t").snapshot_seqs          # snapshots happened
    pool.close()
    pool2 = _open(tmp_path)
    r = pool2.query("t")
    assert r.status == FRESH
    np.testing.assert_array_equal(r.values, _twin(chunks).query_many())
    pool2.close()


def test_snapshot_refuses_while_an_owner_is_down(tmp_path):
    pool = _fast_pool(durability_dir=str(tmp_path))
    placement = pool.create_stream("t", _spec(), shards=SHARDS)
    _feed(pool, _chunks(4))
    pool.kill_host(placement[0])
    with pytest.raises(HostDownError):
        pool.snapshot("t")
    pool.close()


# ---------------------------------------------------------------------------
# availability smoke
# ---------------------------------------------------------------------------

def test_availability_smoke_host_kill_mid_stream(tmp_path):
    pool = _fast_pool(durability_dir=str(tmp_path), pending_limit=256)
    placement = pool.create_stream("t", _spec(), shards=SHARDS)
    chunks = _chunks(40, seed=7)
    twin = SegmentQueryEngine(_spec(), shards=SHARDS, device="cpu")
    statuses = {FRESH: 0, STALE: 0, REJECTED: 0}
    unlabeled = 0
    with FaultInjector() as inj:
        inj.kill_host(pool, placement[0], at=20)
        for sh, k, w in chunks:
            try:
                pool.absorb("t", k, w, shard=sh)
            except RejectedError:
                continue                   # shed ingest is not a read miss
            twin.absorb(k, w, shard=sh)
            r = pool.query("t")
            statuses[r.status] += 1
            if r.status == FRESH:
                if (r.epoch_lag != 0
                        or not np.array_equal(r.values, twin.query_many())):
                    unlabeled += 1
            elif r.status == STALE:
                if r.values is None or (r.epoch_lag == 0
                                        and r.error is None):
                    unlabeled += 1
    total = sum(statuses.values())
    availability = (statuses[FRESH] + statuses[STALE]) / total
    assert availability >= 0.99, statuses
    assert unlabeled == 0
    pool.rebalance("t")
    r = pool.query("t")
    assert r.status == FRESH
    np.testing.assert_array_equal(r.values, twin.query_many())
    pool.close()


# ---------------------------------------------------------------------------
# per-host gauges (telemetry)
# ---------------------------------------------------------------------------

def test_host_stats_and_telemetry_gauges():
    pool = _fast_pool()
    pool.create_stream("t", _spec(), shards=SHARDS)
    _feed(pool, _chunks(8))
    pool.query("t")
    g = TS.collect_host_gauges(pool)
    assert set(g["hosts"]) == set(HOSTS)
    assert g["totals"]["hosts_alive"] == len(HOSTS)
    assert g["totals"]["owned_shards"] == SHARDS
    assert g["totals"]["live_shards"] >= 1
    assert g["totals"]["bytes_resident"] > 0
    assert g["totals"]["replica_streams"] == 2   # primary + follower
    pool.kill_host(HOSTS[0])
    g2 = TS.collect_host_gauges(pool)
    assert g2["totals"]["hosts_alive"] == len(HOSTS) - 1
    assert not g2["hosts"][HOSTS[0]]["alive"]
    assert g2["hosts"][HOSTS[0]]["live_shards"] == 0


# ---------------------------------------------------------------------------
# against the reference pool
# ---------------------------------------------------------------------------

def _ref_pool(**kw):
    kw.setdefault("hosts", HOSTS)
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("backoff_base", 1e-4)
    return RefPool(**kw)


def _assert_answers(ref_vals, port_vals):
    np.testing.assert_allclose(port_vals, np.asarray(ref_vals),
                               rtol=EST_RTOL, atol=0.0)


def test_scaleout_matches_reference_through_kill_and_rebalance(tmp_path):
    """Same chunks into the reference's pool and the port's: placements
    identical, the cross-host merged slab within the parity bounds, every
    answer (FRESH, STALE after a kill, FRESH after the rebalance) within
    EST_RTOL, statuses, lags and gauges equal."""
    preds = [C.EVERYTHING, C.key_range(0, 300), C.key_mask(3, 1)]
    tpreds = [T.EVERYTHING, T.key_range(0, 300), T.key_mask(3, 1)]
    ref = _ref_pool(durability_dir=str(tmp_path / "ref"))
    port = _fast_pool(durability_dir=str(tmp_path / "port"))
    assert (ref.create_stream("t", _ref_spec(), shards=SHARDS)
            == port.create_stream("t", _spec(), shards=SHARDS))
    chunks = _chunks()
    _feed(ref, chunks)
    _feed(port, chunks)
    rr, pr = ref.query("t", predicates=preds), port.query("t",
                                                          predicates=tpreds)
    assert rr.status == pr.status == FRESH
    _assert_answers(rr.values, pr.values)
    assert_slab_parity(ref._cross_merged(ref._stream("t")),
                       port._cross_merged(port._stream("t")), "cross ")
    victim = port.placement("t")[0]
    ref.kill_host(victim)
    port.kill_host(victim)
    extra = _chunks(4, seed=21)
    _feed(ref, extra)
    _feed(port, extra)
    rr, pr = ref.query("t", predicates=preds), port.query("t",
                                                          predicates=tpreds)
    assert rr.status == pr.status == STALE
    assert rr.epoch_lag == pr.epoch_lag
    _assert_answers(rr.values, pr.values)
    ro, po = ref.rebalance("t")["t"], port.rebalance("t")["t"]
    assert ro["placement"] == po["placement"]
    assert ro["moved"] == po["moved"] and ro["marker_seq"] == po["marker_seq"]
    rr, pr = ref.query("t", predicates=preds), port.query("t",
                                                          predicates=tpreds)
    assert rr.status == pr.status == FRESH
    _assert_answers(rr.values, pr.values)
    assert_slab_parity(ref._cross_merged(ref._stream("t")),
                       port._cross_merged(port._stream("t")), "rebalanced ")
    rs, ps = ref.stats("t"), port.stats("t")
    for key in ("ingest_seq", "applied_seq", "placement", "owners",
                "replica_hosts"):
        assert rs[key] == ps[key], key
    rg = RS.collect_host_gauges(ref)
    pg = TS.collect_host_gauges(port)
    for key in ("hosts", "hosts_alive", "live_shards", "owned_shards",
                "replica_streams"):
        assert rg["totals"][key] == pg["totals"][key], key
    ref.close()
    port.close()


def test_reopened_pool_matches_reference_after_join_and_leave(tmp_path):
    ref = _ref_pool(durability_dir=str(tmp_path / "ref"), snapshot_every=6)
    port = _fast_pool(durability_dir=str(tmp_path / "port"),
                      snapshot_every=6)
    ref.create_stream("t", _ref_spec(3), shards=SHARDS)
    port.create_stream("t", _spec(3), shards=SHARDS)
    chunks = _chunks(14, seed=5)
    _feed(ref, chunks[:7])
    _feed(port, chunks[:7])
    for pool in (ref, port):
        pool.host_join(7)
        pool.rebalance("t")
    _feed(ref, chunks[7:])
    _feed(port, chunks[7:])
    for pool in (ref, port):
        pool.host_leave(1)
        pool.close()
    ref2 = RefPool.open(str(tmp_path / "ref"), sleep=lambda s: None)
    port2 = _open(tmp_path / "port")
    assert ref2.hosts == port2.hosts and ref2.placement("t") == \
        port2.placement("t")
    rr, pr = ref2.query("t"), port2.query("t")
    assert rr.status == pr.status == FRESH
    _assert_answers(rr.values, pr.values)
    np.testing.assert_array_equal(
        pr.values, _twin(chunks, spec=_spec(3)).query_many())
    ref2.close()
    port2.close()


def test_merge_host_slabs_matches_reference_and_single_slab_passes():
    spec, rspec = _spec(), _ref_spec()
    chunks = _chunks(8)
    slabs, rslabs = [], []
    for h in range(3):
        eng = SegmentQueryEngine(spec, shards=2, device="cpu")
        reng = RefEngine(rspec, shards=2)
        for sh, k, w in chunks[h::3]:
            eng.absorb(k, w, shard=sh % 2)
            reng.absorb(k, w, shard=sh % 2)
        slabs.append(eng.merged)
        rslabs.append(reng.merged)
    merged = merge_host_slabs(spec, slabs)
    assert_slab_parity(ref_merge(rspec, rslabs), merged, "merged ")
    assert_slabs_bitsame(merged, _twin(chunks).merged)
    assert merge_host_slabs(spec, slabs[:1]) is slabs[0]
    with pytest.raises(ValueError):
        merge_host_slabs(spec, [])


def test_load_stacked_matches_reference_and_set_shard_engine():
    spec, rspec = _spec(1), _ref_spec(1)
    chunks = _chunks(6, seed=8)
    parts = [T.multisketch_build(spec, k, w, device="cpu")
             for _, k, w in chunks]
    rparts = [C.multisketch_build(rspec, k, w) for _, k, w in chunks]
    stacked = T.MultiSketch(*(torch.stack(x) for x in zip(*parts)))
    rstacked = C.MultiSketch(*(np.stack([np.asarray(f) for f in x])
                               for x in zip(*rparts)))
    eng = SegmentQueryEngine(spec, shards=1, device="cpu")
    eng.load_stacked(stacked)
    reng = RefEngine(rspec, shards=1)
    reng.load_stacked(C.MultiSketch(*(np.asarray(x) for x in rstacked)))
    assert eng.num_shards == len(chunks)
    assert eng.merge_stats["live_shards"] == len(chunks)
    other = SegmentQueryEngine(spec, shards=len(chunks), device="cpu")
    for i, p in enumerate(parts):
        other.set_shard(i, p)
    assert_slabs_bitsame(eng.merged, other.merged)
    assert_slab_parity(reng.merged, eng.merged, "load_stacked ")
    np.testing.assert_allclose(eng.query_many(), np.asarray(
        reng.query_many()), rtol=EST_RTOL, atol=0.0)


def test_multisketch_estimate_matches_reference():
    spec, rspec = _spec(), _ref_spec()
    k = np.arange(500, dtype=np.int32)
    w = np.random.default_rng(4).lognormal(0, 1, 500).astype(np.float32)
    sk = T.multisketch_build(spec, k, w, device="cpu")
    rsk = C.multisketch_build(rspec, k, w)
    for f, rf in ((T.SUM, C.SUM), (T.COUNT, C.COUNT)):
        for seg in (None, lambda x: x < 250):
            got = float(T.multisketch_estimate(sk, f, seg))
            want = float(C.multisketch_estimate(rsk, rf, seg))
            assert abs(got - want) <= EST_RTOL * abs(want)


# ---------------------------------------------------------------------------
# StatsCollector
# ---------------------------------------------------------------------------

def _collector(cls, **kw):
    if cls is TS.StatsCollector:
        return cls(TS.TelemetryConfig(**kw), device="cpu")
    return cls(RS.TelemetryConfig(**kw))


def test_stats_collector_streaming_and_segments():
    tel = _collector(TS.StatsCollector, k=48, capacity=512, seed=9)
    rng = np.random.default_rng(0)
    all_k, all_w = [], []
    for step in range(12):
        m = int(rng.integers(40, 160))           # ragged chunks
        w = rng.lognormal(0, 1, m).astype(np.float32)
        keys = step * 1000 + np.arange(m)
        tel.absorb(keys, w)
        all_k.append(keys)
        all_w.append(w)
    keys = np.concatenate(all_k)
    w = np.concatenate(all_w)
    slack = 4 / np.sqrt(47)                      # ~4 sigma at k=48
    assert abs(tel.query(T.SUM) / w.sum() - 1) < slack
    assert abs(tel.query(T.COUNT) / len(w) - 1) < slack
    seg = lambda k: k >= 6000                    # noqa: E731
    exact = w[keys >= 6000].sum()
    assert abs(tel.query(T.SUM, segment_fn=seg) / exact - 1) < 2 * slack
    t2 = _collector(TS.StatsCollector, k=48, capacity=512, seed=9)
    t2.absorb(np.arange(50) + 500_000, np.ones(50, np.float32))
    tel.merge_from(t2)
    assert abs(tel.query(T.SUM) / (w.sum() + 50) - 1) < slack


def test_stats_collector_matches_reference():
    """Three ragged absorbs, a merge and every query path against the
    reference's collector on the same numpy inputs."""
    tel = _collector(TS.StatsCollector, k=48, capacity=512, seed=9)
    ref = _collector(RS.StatsCollector, k=48, capacity=512, seed=9)
    rng = np.random.default_rng(0)
    for step in range(3):
        m = int(rng.integers(40, 160))
        w = rng.lognormal(0, 1, m).astype(np.float32)
        keys = step * 1000 + np.arange(m)
        tel.absorb(keys, w)
        ref.absorb(keys, w)
    assert_slab_parity(ref.sketch, tel.sketch, "collector ")
    t2 = _collector(TS.StatsCollector, k=48, capacity=512, seed=9)
    r2 = _collector(RS.StatsCollector, k=48, capacity=512, seed=9)
    t2.absorb(np.arange(50) + 500_000, np.ones(50, np.float32))
    r2.absorb(np.arange(50) + 500_000, np.ones(50, np.float32))
    tel.merge_from(t2)
    ref.merge_from(r2)
    assert_slab_parity(ref.sketch, tel.sketch, "merged collector ")
    seg = lambda k: k >= 1000                    # noqa: E731
    got = tel.query(T.SUM, segment_fn=seg)
    assert abs(got - ref.query(C.SUM, segment_fn=seg)) <= EST_RTOL * got
    qm = tel.query_many((T.SUM, T.COUNT),
                        (T.EVERYTHING, T.key_range(0, 1349)))
    rqm = ref.query_many((C.SUM, C.COUNT),
                         (C.EVERYTHING, C.key_range(0, 1349)))
    np.testing.assert_allclose(qm, np.asarray(rqm), rtol=EST_RTOL, atol=0.0)
    assert tel.stats() == {k: (bool(v) if k == "multisketch_overflow"
                               else int(v))
                           for k, v in ref.stats().items()}


def test_stats_collector_warns_once_on_overflow():
    tel = _collector(TS.StatsCollector, k=48, capacity=64, chunk=64)
    w = np.random.default_rng(0).lognormal(0, 2, 512).astype(np.float32)
    tel.absorb(np.arange(512), w)
    assert tel.overflow
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tel.query(T.SUM)
        tel.query(T.COUNT)               # second query: no second warning
    hits = [x for x in rec if "overflowed" in str(x.message)]
    assert len(hits) == 1 and issubclass(hits[0].category, RuntimeWarning)
    ok = _collector(TS.StatsCollector, k=8, capacity=512)
    ok.absorb(np.arange(64), np.ones(64, np.float32))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ok.query(T.SUM)
    assert not ok.overflow
    assert not [x for x in rec if "overflowed" in str(x.message)]


def test_collector_routes_queries_through_batched_path(monkeypatch):
    rng = np.random.default_rng(0)
    tel = _collector(TS.StatsCollector, k=48, capacity=512, seed=9)
    w = rng.lognormal(0, 1, 700).astype(np.float32)
    tel.absorb(np.arange(700), w)
    q_pred = tel.query(T.SUM, T.key_range(0, 349))
    q_call = tel.query(T.SUM, segment_fn=lambda k: k < 350)
    assert abs(q_pred - q_call) <= 1e-3 * max(1.0, abs(q_call))
    qm = tel.query_many((T.SUM, T.COUNT),
                        (T.EVERYTHING, T.key_range(0, 349)))
    assert qm.shape == (2, 2)
    assert abs(qm[0, 0] - tel.query(T.SUM)) <= 1e-3 * abs(qm[0, 0])
    # predicate queries go through the batched estimate, once per query
    calls = []
    orig = TS.multisketch_query_many

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(TS, "multisketch_query_many", spy)
    for _ in range(4):
        tel.query(T.SUM)
    assert len(calls) == 4


def test_telemetry_streaming_queries():
    tel = _collector(TS.StatsCollector, k=32, capacity=512)
    rng = np.random.default_rng(0)
    all_w = []
    for step in range(10):
        w = rng.lognormal(0, 1, 100).astype(np.float32)
        tel.absorb(step * 1000 + np.arange(100), w)
        all_w.append(w)
    w = np.concatenate(all_w)
    assert abs(tel.query(T.SUM) / w.sum() - 1) < 0.5
    assert abs(tel.query(T.COUNT) / 1000 - 1) < 0.5


def test_collector_state_keeps_to_its_device():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):       # the card is the default
            TS.StatsCollector(TS.TelemetryConfig())
    tel = _collector(TS.StatsCollector)
    assert tel.sketch.keys.device.type == "cpu"
    assert to_np(tel.sketch.valid).sum() == 0
