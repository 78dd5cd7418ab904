"""Parity of the port's MultiSketch (``repro_torch.core.multi_sketch``) with
the JAX package's, on the same numpy inputs, and bit-identity of the port's
own fold paths. The reference runs its Pallas kernels in interpret mode;
the port runs the kernels' plain versions on the CPU. Tolerances:
tests/torch_parity.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as C                                        # noqa: E402
import repro_torch.core as T                                  # noqa: E402
from repro.core import multi_sketch as RMS                    # noqa: E402
from repro_torch.core import multi_sketch as TMS              # noqa: E402
from repro_torch import interop                               # noqa: E402
from tests.torch_parity import (EST_RTOL, assert_slab_parity,  # noqa: E402
                                assert_slabs_bitsame, to_np)

_POOL_C = [(C.SUM, 16), (C.COUNT, 8), (C.thresh(2.0), 12), (C.cap(1.5), 8),
           (C.moment(1.5), 8), (C.thresh(0.5), 8), (C.cap(4.0), 8),
           (C.moment(0.5), 8)]
_POOL_T = [(T.SUM, 16), (T.COUNT, 8), (T.thresh(2.0), 12), (T.cap(1.5), 8),
           (T.moment(1.5), 8), (T.thresh(0.5), 8), (T.cap(4.0), 8),
           (T.moment(0.5), 8)]


def _specs(nf, scheme="ppswor", seed=11, capacity=0):
    return (C.MultiSketchSpec(tuple(_POOL_C[:nf]), scheme, seed, capacity),
            T.MultiSketchSpec(tuple(_POOL_T[:nf]), scheme, seed, capacity))


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(np.arange(5, 5 + n)).astype(np.int32)
    w = rng.lognormal(0, 1.5, n).astype(np.float32)
    return keys, w


def _port(ref_slab):
    return interop.from_arrays([np.asarray(x) for x in ref_slab],
                               device="cpu")


# ------------------------------------------------------------------- build
@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("nf", [1, 3, 8])
def test_build_matches_reference(scheme, nf):
    cs, ts = _specs(nf, scheme)
    keys, w = _data(1500, nf)
    assert_slab_parity(C.multisketch_build(cs, keys, w),
                       T.multisketch_build(ts, keys, w, device="cpu"))


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
def test_plain_selection_path_matches_reference(scheme):
    cs, ts = _specs(3, scheme)
    keys, w = _data(1000, 4)
    act = np.random.default_rng(4).random(1000) > 0.2
    ref = C.multisketch_build(cs, keys, w, act, use_kernels=False)
    port = T.multisketch_build(ts, keys, w, act, use_kernels=False,
                               device="cpu")
    assert_slab_parity(ref, port)
    # the port's two paths agree bit for bit
    assert_slabs_bitsame(port, T.multisketch_build(ts, keys, w, act,
                                                   device="cpu"))


def test_runtime_seed_build_matches_reference():
    cs, ts = _specs(3, seed=0)
    keys, w = _data(800, 2)
    assert_slab_parity(C.multisketch_build(cs, keys, w, seed=123),
                       T.multisketch_build(ts, keys, w, seed=123,
                                           device="cpu"))
    spec123 = T.MultiSketchSpec(ts.objectives, ts.scheme, 123)
    assert_slabs_bitsame(T.multisketch_build(ts, keys, w, seed=123,
                                             device="cpu"),
                         T.multisketch_build(spec123, keys, w, device="cpu"))


@pytest.mark.parametrize("case", ["n1", "k_ge_n", "all_inactive", "ties",
                                  "ragged3000"])
def test_build_edge_inputs(case):
    cs, ts = _specs(3)
    keys, w = _data(3000 if case == "ragged3000" else 40, 9)
    act = np.ones(len(keys), bool)
    if case == "n1":
        keys, w, act = keys[:1], w[:1], act[:1]
    elif case == "all_inactive":
        act[:] = False
    elif case == "ties":
        w = np.resize(np.array([1, 1, 1, 0.5], np.float32), len(keys))
    ref = C.multisketch_build(cs, keys, w, act)
    port = T.multisketch_build(ts, keys, w, act, device="cpu")
    assert_slab_parity(ref, port)
    if case == "all_inactive":
        assert not bool(port.valid.any())


def test_bogus_scheme_raises():
    with pytest.raises(ValueError):
        T.MultiSketchSpec(((T.SUM, 4),), scheme="pps")


def test_hypothesis_counterexample_draw_matches_reference():
    """(0, [1.0]*6, 'ppswor', 1, 0, 0): tied weights, where build compacts
    in input order and the folds in key order. The port copies each path's
    order, so every path matches the reference's."""
    cs = C.MultiSketchSpec(((C.SUM, 5),), "ppswor", 0)
    ts = T.MultiSketchSpec(((T.SUM, 5),), "ppswor", 0)
    # tests/test_merge_properties.py's draw -> inputs, then its 3-way split
    keys = np.random.default_rng(0).choice(200_000, size=6,
                                           replace=False).astype(np.int32)
    ws = np.ones(6, np.float32)
    parts = [(keys[:1], ws[:1]), (keys[1:3], ws[1:3]), (keys[3:], ws[3:])]
    rs = [C.multisketch_build(cs, k, w) for k, w in parts]
    ps = [T.multisketch_build(ts, k, w, device="cpu") for k, w in parts]
    for r, p in zip(rs, ps):
        assert_slab_parity(r, p)
    left_r = C.multisketch_merge(cs, C.multisketch_merge(cs, rs[0], rs[1]),
                                 rs[2])
    left_p = T.multisketch_merge(ts, T.multisketch_merge(ts, ps[0], ps[1]),
                                 ps[2])
    right_r = C.multisketch_merge(cs, rs[0],
                                  C.multisketch_merge(cs, rs[1], rs[2]))
    right_p = T.multisketch_merge(ts, ps[0],
                                  T.multisketch_merge(ts, ps[1], ps[2]))
    assert_slab_parity(left_r, left_p, "left: ")
    assert_slab_parity(right_r, right_p, "right: ")
    assert_slab_parity(C.multisketch_build(cs, keys, ws),
                       T.multisketch_build(ts, keys, ws, device="cpu"),
                       "whole: ")


# ------------------------------------------------------------------- folds
@pytest.fixture(scope="module")
def fold_case():
    """Reference and port slabs from every fold path over one data set."""
    cs, ts = _specs(3, "ppswor", seed=2)
    keys, w = _data(1200, 3)
    chunks = np.array_split(np.arange(1200), 3)
    ref, port = {}, {}
    ref["build"] = C.multisketch_build(cs, keys, w)
    port["build"] = T.multisketch_build(ts, keys, w, device="cpu")
    rst, pst = C.multisketch_empty(cs), T.multisketch_empty(ts, "cpu")
    for ch in chunks:
        rst = C.multisketch_absorb(rst, keys[ch], w[ch], spec=cs)
        pst = T.multisketch_absorb(pst, keys[ch], w[ch], spec=ts)
    ref["absorb"], port["absorb"] = rst, pst
    rparts = [C.multisketch_build(cs, keys[ch], w[ch]) for ch in chunks]
    pparts = [T.multisketch_build(ts, keys[ch], w[ch], device="cpu")
              for ch in chunks]
    ref["merge"] = C.multisketch_merge(
        cs, C.multisketch_merge(cs, rparts[0], rparts[1]), rparts[2])
    port["merge"] = T.multisketch_merge(
        ts, T.multisketch_merge(ts, pparts[0], pparts[1]), pparts[2])
    rstack = C.MultiSketch(*jax.tree.map(lambda *xs: jnp.stack(xs), *rparts))
    ref["merge_stacked"] = C.multisketch_merge_stacked(cs, rstack)
    port["merge_stacked"] = T.multisketch_merge_stacked(
        ts, T.MultiSketch(*(torch.stack(xs) for xs in zip(*pparts))))
    cached_r = C.multisketch_merge(cs, rparts[0], rparts[1])
    cached_p = T.multisketch_merge(ts, pparts[0], pparts[1])
    ref["absorb_into"] = RMS.multisketch_absorb_into(
        jax.tree.map(jnp.copy, cached_r), rparts[2], spec=cs)
    port["absorb_into"] = TMS.multisketch_absorb_into(cached_p, pparts[2],
                                                      spec=ts)
    ref["absorb_slabs"] = RMS.multisketch_absorb_slabs(
        C.multisketch_empty(cs), rstack.keys, rstack.weights, rstack.valid,
        spec=cs)
    port["absorb_slabs"] = TMS.multisketch_absorb_slabs(
        T.multisketch_empty(ts, "cpu"), torch.stack([p.keys for p in pparts]),
        torch.stack([p.weights for p in pparts]),
        torch.stack([p.valid for p in pparts]), spec=ts)
    return ref, port, cs, ts, keys, w


@pytest.mark.parametrize("path", ["build", "absorb", "merge", "merge_stacked",
                                  "absorb_into", "absorb_slabs"])
def test_fold_path_matches_reference(fold_case, path):
    ref, port, *_ = fold_case
    assert_slab_parity(ref[path], port[path], f"{path}: ")


@pytest.mark.parametrize("path", ["absorb", "merge", "merge_stacked",
                                  "absorb_into", "absorb_slabs"])
def test_fold_paths_bit_identical_within_port(fold_case, path):
    _, port, *_ = fold_case
    assert_slabs_bitsame(port["build"], port[path], f"{path}: ")


def test_absorb_leaves_input_state_intact(fold_case):
    _, port, _, ts, keys, w = fold_case
    before = [x.clone() for x in port["merge"]]
    T.multisketch_absorb(port["merge"], keys[:10] + 10_000, w[:10], spec=ts)
    assert_slabs_bitsame(T.MultiSketch(*before), port["merge"])


def test_merge_dedups_by_max_weight_and_inactive_never_shadows():
    cs, ts = (C.MultiSketchSpec(((C.SUM, 4),)),
              T.MultiSketchSpec(((T.SUM, 4),)))
    ka, wa = np.arange(6), np.full(6, 2.0, np.float32)
    wb = np.array([9., 1., 1., 1., 1., 1.], np.float32)
    ref = C.multisketch_merge(cs, C.multisketch_build(cs, ka, wa),
                              C.multisketch_build(cs, ka, wb))
    port = T.multisketch_merge(
        ts, T.multisketch_build(ts, ka, wa, device="cpu"),
        T.multisketch_build(ts, ka, wb, device="cpu"))
    assert_slab_parity(ref, port)
    st = T.multisketch_absorb(T.multisketch_empty(ts, "cpu"),
                              np.array([7, 7]), np.array([5.0, 3.0],
                                                         np.float32),
                              np.array([False, True]), spec=ts)
    assert int(st.member.sum()) == 1
    assert float(st.weights[st.member][0]) == 3.0


def test_port_reads_reference_slab_and_folds_on():
    """A reference slab handed over through interop folds on in the port
    exactly as it does in the reference."""
    cs, ts = _specs(3, seed=4)
    keys, w = _data(900, 6)
    rbase = C.multisketch_build(cs, keys[:600], w[:600])
    ref = C.multisketch_absorb(jax.tree.map(jnp.copy, rbase), keys[600:],
                               w[600:], spec=cs)
    port = T.multisketch_absorb(_port(rbase), keys[600:], w[600:], spec=ts)
    assert_slab_parity(ref, port)


# -------------------------------------------------------- boundary seed ties
def test_boundary_tie_keeps_positive_probability():
    """With a seed tie at the bottom-k boundary (kth == tau) the selection
    keeps both tied keys as members. The reference's finalize recovers
    membership as seed < tau and leaves them p = 0 (an infinite HT weight);
    the port's finalize keeps the selection's p. Two keys of 200k share a
    24-bit u, so streams of millions of keys hit this routinely."""
    keys = np.arange(200_000, dtype=np.int32)
    u = to_np(T.uniform01(torch.from_numpy(keys), 0))
    order = np.argsort(u, kind="stable")
    j = int(np.nonzero(u[order][1:] == u[order][:-1])[0][0])
    a, b = order[j], order[j + 1]
    ks = np.concatenate([[a, b], keys[u > u[a]][:20]]).astype(np.int32)
    w = np.ones(len(ks), np.float32)
    ts = T.MultiSketchSpec(((T.COUNT, 1),))
    port = T.multisketch_build(ts, ks, w, device="cpu")
    assert int(port.member.sum()) == 2
    assert bool((port.probs[port.member] > 0).all())
    est = T.multisketch_query_many(port, [T.COUNT], T.EVERYTHING)[0, 0]
    assert 0 < est < 1e6
    ref = C.multisketch_build(C.MultiSketchSpec(((C.COUNT, 1),)), ks, w)
    assert float(np.asarray(ref.probs)[np.asarray(ref.member)].max()) == 0.0


# ----------------------------------------------------------------- queries
@pytest.mark.parametrize("b", [1, 16, 128])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_query_many_matches_reference(fold_case, b, use_kernels):
    ref, port, cs, ts, keys, _ = fold_case
    rng = np.random.default_rng(b)
    rows = []
    for i in range(b):
        lo = int(rng.integers(0, 1200))
        rows.append([C.key_range(lo, lo + 400), C.key_mask(3, i % 4),
                     C.hash_fraction(0.4, i)][i % 3])
    table = C.encode_predicates(rows)
    fs_c = [f for f, _ in cs.objectives]
    fs_t = [f for f, _ in ts.objectives]
    want = C.multisketch_query_many(ref["absorb"], fs_c, table,
                                    use_kernels=use_kernels)
    got = T.multisketch_query_many(port["absorb"], fs_t, table,
                                   use_kernels=use_kernels)
    assert got.shape == (3, b)
    np.testing.assert_allclose(got, want, rtol=EST_RTOL, atol=1e-4)


def test_combo_objective_query_takes_plain_path(fold_case):
    ref, port, *_ = fold_case
    fc = C.combo((0.5, C.SUM), (2.0, C.cap(1.5)))
    ft = T.combo((0.5, T.SUM), (2.0, T.cap(1.5)))
    np.testing.assert_allclose(
        T.multisketch_query_many(port["absorb"], [ft], T.EVERYTHING),
        C.multisketch_query_many(ref["absorb"], [fc], C.EVERYTHING),
        rtol=EST_RTOL)


# ------------------------------------------------------------ host helpers
def test_pad_chunk_and_quarantine_chunk_match_reference():
    keys = np.array([1, 2, 3, -4, 5, 6, 2 ** 40], np.int64)
    w = np.array([1.0, np.nan, np.inf, 2.0, -3.0, 4.0, 1.0], np.float64)
    for r, p in zip(RMS.quarantine_chunk(keys, w),
                    TMS.quarantine_chunk(keys, w)):
        np.testing.assert_array_equal(r, p)
    k, ww = np.arange(300, dtype=np.int32), np.linspace(0, 2, 300)
    for r, p in zip(RMS.pad_chunk(k, ww, chunk=256),
                    TMS.pad_chunk(k, ww, chunk=256)):
        np.testing.assert_array_equal(r, p)


def test_spec_meta_codec_shared_with_reference():
    cs = C.MultiSketchSpec(((C.SUM, 8), (C.combo((0.5, C.SUM),
                                                  (2.0, C.cap(1.5))), 4)),
                           scheme="priority", seed=7, capacity=40)
    meta = RMS.spec_to_meta(cs)
    ts = TMS.spec_from_meta(meta)
    assert TMS.spec_to_meta(ts) == meta
    assert ts.cap == cs.cap and ts.nf == cs.nf
    assert TMS.multisketch_slab_bytes(ts) == RMS.multisketch_slab_bytes(cs)


def test_overflow_flag_and_finalize_idempotent(fold_case):
    _, port, _, ts, *_ = fold_case
    assert not bool(T.multisketch_overflow(port["build"]))
    assert_slabs_bitsame(T.multisketch_finalize(port["build"], spec=ts),
                         port["build"])
    small = T.MultiSketchSpec(ts.objectives, capacity=10)
    full = T.multisketch_build(small, np.arange(500), np.ones(500),
                               device="cpu")
    assert bool(T.multisketch_overflow(full))
