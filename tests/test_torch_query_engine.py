"""Parity of the port's ``SegmentQueryEngine`` (``repro_torch.launch.query``)
with the JAX package's: the same op sequence through both engines, compared
on ``merge_stats`` (the hit / incremental / full ladder, absorb-time folds,
GC merges, gauges) and answers; plus the engine contracts (held merged slab
survives later absorbs, empty engine answers zeros, GC == union, checkpoint
round trips, and checkpoints carried between the packages)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as C                                        # noqa: E402
import repro_torch.core as T                                  # noqa: E402
from repro.launch.query import SegmentQueryEngine as RefEngine  # noqa: E402
from repro_torch.launch.query import SegmentQueryEngine as Engine  # noqa
from tests.faults import CKPT_CORRUPTIONS, corrupt_checkpoint  # noqa: E402
from tests.torch_parity import (EST_RTOL, assert_slab_parity,  # noqa: E402
                                assert_slabs_bitsame, to_np)


def _specs(scheme="ppswor", seed=5, capacity=0):
    return (C.MultiSketchSpec(((C.SUM, 12), (C.COUNT, 6), (C.moment(1.5), 8)),
                              scheme, seed, capacity),
            T.MultiSketchSpec(((T.SUM, 12), (T.COUNT, 6), (T.moment(1.5), 8)),
                              scheme, seed, capacity))


def _chunks(n_chunks, n=120, seed=3):
    rng = np.random.default_rng(seed)
    return [((i * n + np.arange(n)).astype(np.int32),
             rng.lognormal(0, 1.5, n).astype(np.float32))
            for i in range(n_chunks)]


def _tables():
    rc = C.encode_predicates([C.EVERYTHING, C.key_range(100, 700),
                              C.key_mask(3, 2), C.hash_fraction(0.3, 9)])
    return rc, rc.copy()


def _ladder(stats):
    return {k: stats[k] for k in ("full", "incremental", "hit",
                                  "absorb_time", "gc_merges", "live_shards",
                                  "bytes_resident", "overflow")}


def _run_sequence(ref, port, ops):
    """Apply the same ops to both engines, comparing after every query."""
    rc, tc = _tables()
    for op, *args in ops:
        if op == "absorb":
            keys, w, shard = args
            ref.absorb(keys, w, shard=shard)
            port.absorb(keys, w, shard=shard)
        elif op == "query":
            np.testing.assert_allclose(port.query_many(predicates=tc),
                                       ref.query_many(predicates=rc),
                                       rtol=EST_RTOL)
        elif op == "gc":
            assert port.gc(max_live=args[0]) == ref.gc(max_live=args[0])
        elif op == "add_shard":
            ref.add_shard(ref.merged)
            port.add_shard(port.merged)
        elif op == "set_shard":
            ref.set_shard(args[0], ref.shard_slab(0))
            port.set_shard(args[0], port.shard_slab(0))
        elif op == "clear_shard":
            ref.clear_shard(args[0])
            port.clear_shard(args[0])
        assert _ladder(port.merge_stats) == _ladder(ref.merge_stats), op
        assert port.epoch == ref.epoch and port.num_shards == ref.num_shards


def _ops(n_shards, chunks):
    ops = []
    for i, (k, w) in enumerate(chunks):
        ops.append(("absorb", k, w, i % n_shards))
        if i % 2:
            ops.append(("query",))
    return ops


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("absorb_time", [True, False])
def test_engine_sequence_matches_reference(scheme, shards, absorb_time):
    cs, ts = _specs(scheme)
    ref = RefEngine(cs, shards=shards, absorb_time=absorb_time)
    port = Engine(ts, shards=shards, absorb_time=absorb_time, device="cpu")
    _run_sequence(ref, port, _ops(shards, _chunks(6)))
    assert_slab_parity(ref.merged, port.merged)


def test_engine_lifecycle_ops_match_reference():
    """add_shard, set_shard (non-monotone: full path), clear_shard and GC
    move the ladder counters identically."""
    cs, ts = _specs()
    ref = RefEngine(cs, shards=3, max_delta=1)
    port = Engine(ts, shards=3, max_delta=1, device="cpu")
    ch = _chunks(8)
    ops = _ops(3, ch[:4]) + [("add_shard",), ("query",), ("set_shard", 2),
                             ("query",), ("absorb", *ch[4], 1),
                             ("absorb", *ch[5], 3), ("query",),
                             ("gc", 2), ("query",), ("clear_shard", 1),
                             ("query",), ("absorb", *ch[6], 0), ("query",)]
    _run_sequence(ref, port, ops)
    assert_slab_parity(ref.merged, port.merged)


def test_truncating_capacity_skips_incremental_like_reference():
    cs, ts = _specs(capacity=12)
    ref = RefEngine(cs, shards=2)
    port = Engine(ts, shards=2, device="cpu")
    _run_sequence(ref, port, _ops(2, _chunks(4)))
    assert port.merge_stats["incremental"] == 0
    assert port.merge_stats["overflow"] is True


def test_merged_handle_survives_later_absorbs():
    _, ts = _specs()
    for shards in (1, 3):
        eng = Engine(ts, shards=shards, device="cpu")
        ch = _chunks(4)
        eng.absorb(*ch[0], shard=0)
        held = eng.merged
        snap = [x.clone() for x in held]
        for i, (k, w) in enumerate(ch[1:]):
            eng.absorb(k, w, shard=i % shards)
        assert_slabs_bitsame(T.MultiSketch(*snap), held)
        assert not torch.equal(eng.merged.keys, held.keys)


def test_empty_engine_answers_zeros_and_shapes():
    _, ts = _specs()
    eng = Engine(ts, shards=2, b_quantum=16, device="cpu")
    out = eng.query_many(predicates=[T.EVERYTHING] * 3)
    assert out.shape == (3, 3) and not out.any()
    assert eng.query(T.SUM) == 0.0
    assert eng.query_many([T.SUM], T.EVERYTHING).shape == (1, 1)
    with pytest.raises(IndexError):
        eng.absorb(np.arange(3), np.ones(3), shard=2)
    with pytest.raises(ValueError):
        Engine(ts, shards=0, device="cpu")


def test_set_shard_copies_and_shard_slab_is_the_resident():
    _, ts = _specs()
    eng = Engine(ts, shards=2, device="cpu")
    sk = T.multisketch_build(ts, np.arange(50), np.ones(50), device="cpu")
    eng.set_shard(1, sk)
    assert eng.shard_slab(1) is not sk and eng.shard_live(1)
    assert_slabs_bitsame(eng.shard_slab(1), sk)
    eng.absorb(np.arange(60, 90), np.ones(30), shard=1)
    assert_slabs_bitsame(T.multisketch_build(ts, np.arange(50), np.ones(50),
                                             device="cpu"), sk)


# --------------------------------------------------------------------- GC
@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
def test_gc_merge_equals_union_and_plans_like_reference(scheme):
    cs, ts = _specs(scheme)
    ref = RefEngine(cs, shards=4)
    port = Engine(ts, shards=4, device="cpu")
    lazy = Engine(ts, shards=4, absorb_time=False, device="cpu")
    for i, (k, w) in enumerate(_chunks(8)):
        ref.absorb(k, w, shard=i % 4)
        port.absorb(k, w, shard=i % 4)
        lazy.absorb(k, w, shard=i % 4)
    for kw in ({"max_live": 2}, {"min_age": 3}, {"max_live": 1, "min_age": 1}):
        assert port.gc_plan(**kw) == ref.gc_plan(**kw)
    before = port.query_many()
    assert port.gc(max_live=1) == ref.gc(max_live=1) == [1, 2, 3]
    assert port.merge_stats["live_shards"] == 1
    assert_slabs_bitsame(port.merged, lazy.merged)
    np.testing.assert_array_equal(port.query_many(), before)
    with pytest.raises(ValueError):
        port.gc_apply([0])


def test_auto_gc_water_mark_and_spill_restore(tmp_path):
    cs, ts = _specs()
    ref = RefEngine(cs, shards=2, gc_max_live=2)
    eng = Engine(ts, shards=2, gc_max_live=2, device="cpu")
    for k, w in _chunks(5):
        ref.add_shard(C.multisketch_build(cs, k, w))
        eng.add_shard(T.multisketch_build(ts, k, w, device="cpu"))
        assert _ladder(eng.merge_stats) == _ladder(ref.merge_stats)
        assert eng.num_shards == ref.num_shards
    assert eng.merge_stats["gc_merges"] > 0
    victims = [i for i in range(eng.num_shards) if eng.shard_live(i)][1:]
    eng.spill(str(tmp_path), victims)
    back = Engine.from_checkpoint(str(tmp_path), device="cpu")
    assert back.num_shards == len(victims)
    for j, i in enumerate(victims):
        assert_slabs_bitsame(back.shard_slab(j), eng.shard_slab(i))


# ------------------------------------------------------------ checkpoints
@pytest.fixture
def saved_engine(tmp_path):
    _, ts = _specs()
    eng = Engine(ts, shards=2, gc_max_live=5, device="cpu")
    for i, (k, w) in enumerate(_chunks(4)):
        eng.absorb(k, w, shard=i % 2)
    eng.save_checkpoint(str(tmp_path))                 # step 0
    eng.absorb(*_chunks(5)[4], shard=0)
    eng.save_checkpoint(str(tmp_path))                 # step 1
    return eng, str(tmp_path)


def test_checkpoint_roundtrip_bit_identical(saved_engine):
    eng, d = saved_engine
    back, extra = Engine.from_checkpoint(d, return_meta=True, device="cpu")
    assert extra["num_shards"] == 2 and back.gc_max_live == 5
    for i in range(2):
        assert_slabs_bitsame(back.shard_slab(i), eng.shard_slab(i))
    np.testing.assert_array_equal(back.query_many(), eng.query_many())


@pytest.mark.parametrize("mode", CKPT_CORRUPTIONS)
def test_corrupt_newest_checkpoint_falls_back(saved_engine, mode):
    _, d = saved_engine
    corrupt_checkpoint(d, mode)
    back = Engine.from_checkpoint(d, device="cpu")
    assert back.num_shards == 2 and back.merge_stats["live_shards"] == 2


def test_reference_checkpoint_restores_bit_identical_in_port(tmp_path):
    cs, ts = _specs(seed=8)
    ref = RefEngine(cs, shards=3)
    for i, (k, w) in enumerate(_chunks(5)):
        ref.absorb(k, w, shard=i % 3)
    ref.save_checkpoint(str(tmp_path / "r"))
    port = Engine.from_checkpoint(str(tmp_path / "r"), device="cpu")
    assert port.spec == ts
    for i in range(3):
        for name, x, y in zip(C.MultiSketch._fields, ref.shard_slab(i),
                              port.shard_slab(i)):
            np.testing.assert_array_equal(np.asarray(x), to_np(y),
                                          err_msg=name)
    rc, tc = _tables()
    np.testing.assert_allclose(port.query_many(predicates=tc),
                               ref.query_many(predicates=rc), rtol=EST_RTOL)
    # and the port's checkpoint restores in the reference, bit for bit
    port.save_checkpoint(str(tmp_path / "p"))
    back = RefEngine.from_checkpoint(str(tmp_path / "p"))
    for i in range(3):
        for name, x, y in zip(C.MultiSketch._fields, back.shard_slab(i),
                              port.shard_slab(i)):
            np.testing.assert_array_equal(np.asarray(x), to_np(y),
                                          err_msg=name)
