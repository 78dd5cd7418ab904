"""Parity of the port's universal-sample tier with the JAX package's, on the
same numpy inputs: pps and bottom-k samples, multi-objective samples, the
universal monotone and capping samples, the buffer scan and mergeable
sketches (mirrors tests/test_core_sampling.py, tests/test_property_
invariants.py and the scan cases of tests/test_query_engine.py). The port
runs on the CPU. Tolerances: tests/torch_parity.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402
import repro.core as C                                        # noqa: E402
import repro_torch.core as T                                  # noqa: E402
import repro_torch.kernels as K                               # noqa: E402
from repro.core import universal as RU                        # noqa: E402
from repro_torch import interop                               # noqa: E402
from repro_torch.core import universal as TU                  # noqa: E402
from tests.torch_parity import (EST_RTOL, PROB_ULP, SEED_ULP,  # noqa: E402
                                assert_ulp, rw_gap_ok, to_np)

CPU = "cpu"
_PAIRS = [(C.SUM, T.SUM), (C.COUNT, T.COUNT), (C.thresh(5.0), T.thresh(5.0)),
          (C.cap(2.0), T.cap(2.0)), (C.moment(1.5), T.moment(1.5))]
# Hypothesis's saved counterexample of the reference's merge property
# tests: (seed, weights, scheme, k, ...) = (0, [1.0]*6, 'ppswor', 1, 0, 0)
TIED6 = np.ones(6, np.float32)


def make_data(rng, n, sigma=1.5, dup_frac=0.0):
    keys = np.arange(n, dtype=np.int32)
    w = rng.lognormal(0, sigma, n).astype(np.float32)
    if dup_frac > 0:  # repeated weights (tie handling paths)
        m = int(n * dup_frac)
        w[:m] = np.round(w[:m], 1)
    return keys, w, rng.random(n) > 0.05


def assert_fields_equal(ref, port, names, what=""):
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      to_np(getattr(port, name)),
                                      err_msg=f"{what}{name}")


# ------------------------------------------------------------ devices
_HOST = (np.arange(8, dtype=np.int32), np.ones(8, np.float32),
         np.ones(8, bool))
_ENTRY_POINTS = {
    "pps_sample": lambda: T.pps_sample(*_HOST, T.SUM, 2),
    "bottomk_sample": lambda: T.bottomk_sample(*_HOST, T.SUM, 2),
    "multi_bottomk_sample": lambda: T.multi_bottomk_sample(
        *_HOST, [(T.SUM, 2)]),
    "universal_monotone_sample": lambda: T.universal_monotone_sample(
        *_HOST, 2),
    "universal_capping_sample": lambda: T.universal_capping_sample(
        *_HOST, 2, m_cap=8),
    "build_sketch": lambda: T.build_sketch(*_HOST, 2, 16),
    "exact": lambda: T.exact(T.SUM, _HOST[1], _HOST[2]),
    "disparity": lambda: T.disparity(T.SUM, T.COUNT, _HOST[1]),
    "sketch_from_arrays": lambda: interop.sketch_from_arrays(
        (*_HOST[:2], _HOST[1], _HOST[2], _HOST[2], 2, 0)),
    "capping_kernel": lambda: K.ops.universal_capping_kernel(*_HOST, 2),
    "multi_objective_kernel": lambda: K.ops.multi_objective_bottomk_kernel(
        *_HOST, ((0, 0.0),), 2),
    "init_model": lambda: _train_mods()[0].init_model(
        _train_mods()[1].get_smoke_config("qwen2-1.5b")),
    "make_host_mesh": lambda: _train_mods()[2].make_host_mesh(),
    "importance_loader": lambda: _train_mods()[3].Loader(
        _train_mods()[3].SyntheticCorpus(_train_mods()[3].DataConfig(
            vocab_size=8, seq_len=4, global_batch=2, n_docs=64)),
        _train_mods()[3].DataConfig(vocab_size=8, seq_len=4, global_batch=2,
                                    n_docs=64), importance=True),
    "train_main": lambda: _train_mods()[4].main(["--smoke", "--steps", "1"]),
    "make_cache": lambda: _train_mods()[0].make_cache(
        _train_mods()[1].get_smoke_config("granite-moe-1b-a400m"), 2, 8),
    "serve_main": lambda: _serve_main(["--smoke", "--arch",
                                       "granite-moe-1b-a400m"])}


def _serve_main(argv):
    from repro_torch.launch import serve
    return serve.main(argv)


def _train_mods():
    """The training path's modules (imported when an entry point runs)."""
    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh, train
    from repro_torch.models import model
    return model, registry, mesh, pipeline, train


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_host_arrays_run_on_the_card_or_raise(monkeypatch, name):
    """Given host arrays and no ``device``, an entry point runs on the card;
    without one it raises instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[name]()


# ------------------------------------------------------ funcs / estimators
@pytest.mark.parametrize("i", range(len(_PAIRS)))
def test_disparity_matches(i):
    grid = np.geomspace(0.05, 50.0, 200).astype(np.float32)
    for cg, tg in _PAIRS:
        cf, tf = _PAIRS[i]
        np.testing.assert_allclose(float(C.disparity(cf, cg, grid)),
                                   float(T.disparity(tf, tg, grid,
                                                     device=CPU)),
                                   rtol=EST_RTOL)


def test_paper_example_1_1_exact_statistics():
    w = np.array([5, 100, 23, 7, 1, 5, 220, 19, 3, 2], np.float32)
    act = np.ones(10, bool)
    H = np.isin(np.arange(10), [1, 3, 7, 9])
    want = {"sum": 128, "count": 4, "thresh_10": 2, "cap_5": 17,
            "moment_2": 10414}
    for f in (T.SUM, T.COUNT, T.thresh(10), T.cap(5), T.moment(2)):
        assert float(T.exact(f, w, act, H, device=CPU)) == want[f.name]


@pytest.mark.parametrize("fi", range(len(_PAIRS)))
def test_estimators_match(fi):
    cf, tf = _PAIRS[fi]
    rng = np.random.default_rng(fi)
    n = 500
    w = rng.lognormal(0, 1.5, n).astype(np.float32)
    act = rng.random(n) > 0.1
    probs = np.where(act, rng.uniform(0.05, 1.0, n), 0).astype(np.float32)
    member = act & (rng.random(n) < 0.6)
    seg = rng.random(n) < 0.4
    ids = rng.integers(-1, 5, n)                 # -1: dropped by both
    pairs = [
        (C.estimate(cf, w, probs, member), T.estimate(
            tf, w, probs, member, device=CPU)),
        (C.estimate(cf, w, probs, member, seg), T.estimate(
            tf, w, probs, member, seg, device=CPU)),
        (C.estimate_segments(cf, w, probs, member, ids, 4),
         T.estimate_segments(tf, w, probs, member, ids, 4, device=CPU)),
        (C.exact(cf, w, act, seg), T.exact(tf, w, act, seg, device=CPU)),
        (C.exact_segments(cf, w, act, ids, 4),
         T.exact_segments(tf, w, act, ids, 4, device=CPU))]
    for ref, port in pairs:
        np.testing.assert_allclose(np.asarray(ref), to_np(port),
                                   rtol=EST_RTOL)


# ----------------------------------------------------------------- pps
def test_paper_example_2_1_pps_probabilities():
    w = np.array([5, 100, 23, 7, 1, 5, 220, 19, 3, 2], np.float32)
    act = np.ones(10, bool)
    p, s = T.pps_probabilities(w, act, T.SUM, 3, device=CPU)
    assert float(s) == 385
    np.testing.assert_allclose(
        np.round(to_np(p), 2), [.04, .78, .18, .05, .01, .04, 1., .15, .02,
                                .02])
    p, s = T.pps_probabilities(w, act, T.thresh(10), 3, device=CPU)
    assert float(s) == 4
    np.testing.assert_allclose(
        to_np(p), [0, .75, .75, 0, 0, 0, .75, .75, 0, 0], atol=1e-6)


def test_paper_example_3_1_multi_objective_size():
    w = np.array([5, 100, 23, 7, 1, 5, 220, 19, 3, 2], np.float32)
    act = np.ones(10, bool)
    objs = [(T.SUM, 3), (T.thresh(10), 3), (T.cap(5), 3)]
    probs = [T.pps_probabilities(w, act, f, k, device=CPU)[0]
             for f, k in objs]
    naive = float(sum(p.sum() for p in probs))
    assert abs(naive - 8.29) < 0.01
    assert abs(float(torch.stack(probs).amax(0).sum()) - 4.816) < 0.01


def _assert_pps_parity(ref, port, keys, seed):
    """Probabilities share an f-sum taken in another order, hence
    EST_RTOL; membership u < p is exact for every key whose u is not
    within that window of p (asserted: no such key in these inputs)."""
    p_ref = np.asarray(ref.prob)
    np.testing.assert_allclose(p_ref, to_np(port.prob), rtol=EST_RTOL)
    u = np.asarray(C.uniform01(keys, seed))
    assert not np.any(np.abs(u - p_ref) <= EST_RTOL * p_ref), \
        "precondition: a key's u lies within EST_RTOL of its p"
    np.testing.assert_array_equal(np.asarray(ref.member), to_np(port.member))


@pytest.mark.parametrize("fi", range(len(_PAIRS)))
def test_pps_sample_matches(fi):
    cf, tf = _PAIRS[fi]
    keys, w, act = make_data(np.random.default_rng(10 + fi), 400)
    ref = C.pps_sample(keys, w, act, cf, 40, seed=3)
    port = T.pps_sample(keys, w, act, tf, 40, seed=3, device=CPU)
    _assert_pps_parity(ref, port, keys, 3)
    np.testing.assert_allclose(float(ref.fsum), float(port.fsum),
                               rtol=EST_RTOL)


def test_multi_pps_sample_matches_and_closure():
    keys, w, act = make_data(np.random.default_rng(4), 400)
    ref = C.multi_pps_sample(keys, w, act, [(f, 20) for f, _ in _PAIRS],
                             seed=5)
    port = T.multi_pps_sample(keys, w, act, [(f, 20) for _, f in _PAIRS],
                              seed=5, device=CPU)
    _assert_pps_parity(ref, port, keys, 5)
    np.testing.assert_allclose(np.asarray(ref.fsums), to_np(port.fsums),
                               rtol=EST_RTOL)
    # Thm 4.1: p^(combo) <= p^(F) pointwise for a non-negative combination
    F = [(T.SUM, 5), (T.cap(2.0), 5)]
    pF = torch.stack([T.pps_probabilities(w, act, f, k, device=CPU)[0]
                      for f, k in F]).amax(0)
    pc, _ = T.pps_probabilities(w, act, T.combo((0.7, T.SUM),
                                                (2.0, T.cap(2.0))), 5,
                                device=CPU)
    assert bool(torch.all(pc <= pF + 1e-6))


# ---------------------------------------------------------------- bottom-k
@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("k", [1, 16, 500])
def test_bottomk_sample_matches(scheme, k):
    keys, w, act = make_data(np.random.default_rng(k), 300)
    for cf, tf in _PAIRS[:4]:
        ref = C.bottomk_sample(keys, w, act, cf, k, scheme, seed=2)
        port = T.bottomk_sample(keys, w, act, tf, k, scheme, seed=2,
                                device=CPU)
        np.testing.assert_array_equal(np.asarray(ref.member),
                                      to_np(port.member))
        assert_ulp(ref.seeds, port.seeds, SEED_ULP, "seeds")
        assert_ulp(ref.tau, port.tau, SEED_ULP, "tau")
        assert_ulp(ref.prob, port.prob, PROB_ULP, "prob")


def test_bottomk_coordination_nesting_and_unbiased():
    keys, w, act = make_data(np.random.default_rng(8), 300)
    prev = None
    for k in (1, 2, 4, 8):
        s = T.bottomk_sample(keys, w, act, T.SUM, k, seed=3, device=CPU)
        if prev is not None:
            assert bool(torch.all(prev <= s.member))
        prev = s.member
    ex = float(T.exact(T.SUM, w, act, device=CPU))
    for scheme in ("ppswor", "priority"):
        ests = [float(T.estimate(T.SUM, w, s.prob, s.member))
                for s in (T.bottomk_sample(keys, w, act, T.SUM, 16, scheme,
                                           seed=i, device=CPU)
                          for i in range(150))]
        assert abs(np.mean(ests) / ex - 1) < 0.09


# -------------------------------------------------------- multi-objective
@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("nf", [1, 3, 5])
def test_multi_bottomk_sample_matches(scheme, nf):
    keys, w, act = make_data(np.random.default_rng(nf), 400)
    ks = (8, 3, 12, 8, 5)
    ref = C.multi_bottomk_sample(keys, w, act,
                                 [(f, k) for (f, _), k in zip(_PAIRS[:nf],
                                                              ks)],
                                 scheme=scheme, seed=1)
    port = T.multi_bottomk_sample(keys, w, act,
                                  [(f, k) for (_, f), k in zip(_PAIRS[:nf],
                                                               ks)],
                                  scheme=scheme, seed=1, device=CPU)
    assert_fields_equal(ref, port, ("member", "aux"))
    assert_ulp(ref.taus, port.taus, SEED_ULP, "taus")
    assert_ulp(ref.prob, port.prob, PROB_ULP, "prob")


def test_multi_objective_union_and_dominance():
    keys, w, act = make_data(np.random.default_rng(0), 400)
    objs = [(T.SUM, 8), (T.thresh(5.0), 8), (T.cap(2.0), 8)]
    mb = T.multi_bottomk_sample(keys, w, act, objs, seed=0, device=CPU)
    for f, kf in objs:
        ded = T.bottomk_sample(keys, w, act, f, kf, seed=0, device=CPU)
        assert bool(torch.all(ded.member <= mb.member))
        assert bool(torch.all(torch.where(ded.member,
                                          mb.prob >= ded.prob - 1e-6,
                                          True)))


# --------------------------------------------------------- the buffer scan
def _scan_case(kind, n, k1, seed):
    rng = np.random.default_rng(seed)
    idx = np.arange(n, dtype=np.int32)
    if kind == "desc":          # saturates the inserted-subsequence bound
        v = np.sort(rng.exponential(1.0, n).astype(np.float32))[::-1].copy()
    elif kind == "equal":       # every element inserts: the full replay
        v = np.full(n, 2.5, np.float32)
    elif kind == "alphabet":    # the tail is almost always tied
        v = rng.choice(np.array([1.0, 2.0, 3.0, 4.0], np.float32), n)
    else:
        v = rng.exponential(1.0, n).astype(np.float32)
        if kind == "quantized":
            v = np.round(v * 8) / 8
        v[rng.random(n) > 0.9] = np.inf    # inactive sentinels mid-stream
        idx = rng.permutation(n).astype(np.int32)
    return v, idx


@pytest.mark.parametrize("kind,n,k1", [
    ("random", 1000, 17), ("quantized", 700, 65), ("quantized", 256, 5),
    ("random", 50, 65), ("quantized", 513, 8), ("quantized", 2048, 129),
    ("random", 1, 3), ("desc", 4096, 9), ("equal", 4096, 9),
    ("alphabet", 1500, 3), ("alphabet", 1500, 17), ("alphabet", 1500, 64)])
def test_buffer_scan_bit_identical(kind, n, k1):
    """_buffer_scan against the port's and the reference's sequential
    _buffer_scan_ref: rank, tail value and tail index bit for bit."""
    v, idx = _scan_case(kind, n, k1, n + k1)
    want = RU._buffer_scan_ref(jnp.asarray(v), jnp.asarray(idx), k1)
    tv, ti = torch.from_numpy(v), torch.from_numpy(idx)
    for got in (TU._buffer_scan(tv, ti, k1), TU._buffer_scan_ref(tv, ti,
                                                                 k1)):
        for name, g, r in zip(("rank", "tail_v", "tail_i"), got, want):
            np.testing.assert_array_equal(np.asarray(r), to_np(g),
                                          err_msg=name)
    if kind in ("desc", "equal"):
        assert TU._insert_bound(n, k1) < n      # the bound overflowed


def test_buffer_scan_tie_eviction_churns_and_pieces():
    v, idx = _scan_case("alphabet", 1500, 3, 7)
    ti = to_np(TU._buffer_scan(torch.from_numpy(v), torch.from_numpy(idx),
                               3)[2])
    assert len(set(ti[v == 4.0].tolist())) > 1
    for n, k1 in ((1, 2), (300, 17), (5000, 65), (1 << 20, 65)):
        assert TU._insert_bound(n, k1) == RU._insert_bound(n, k1)
    sw = np.array([9, 9, 7, 5, 5, 5, 2, -np.inf, -np.inf], np.float32)
    np.testing.assert_array_equal(np.asarray(RU._group_last(jnp.asarray(sw))),
                                  to_np(TU._group_last(torch.from_numpy(sw))))
    for n, k in ((1, 1), (300, 16), (10_000, 64)):
        assert T.expected_size_bound(n, k) == C.expected_size_bound(n, k)
    empty = TU._buffer_scan(torch.zeros(0), torch.zeros(0, dtype=torch.int32),
                            5)
    assert all(x.shape == (0,) for x in empty)


# -------------------------------------------------- universal monotone
@pytest.mark.parametrize("dup", [0.0, 0.5])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_universal_monotone_matches(k, dup):
    keys, w, act = make_data(np.random.default_rng(k), 300, dup_frac=dup)
    ref = C.universal_monotone_sample(keys, w, act, k, seed=7)
    port = T.universal_monotone_sample(keys, w, act, k, seed=7, device=CPU)
    names = ("member", "prob", "aux", "h")
    assert_fields_equal(ref, port, names, "sample ")
    u = np.asarray(C.uniform01(keys, 7))
    assert_fields_equal(C.universal_monotone_ref(w, u, act, k),
                        T.universal_monotone_ref(w, u, act, k, device=CPU),
                        names, "ref ")
    assert_fields_equal(ref, T.universal_monotone_ref(w, u, act, k,
                                                      device=CPU),
                        ("member", "prob", "aux"), "prod vs ref ")
    assert_fields_equal(ref, T.universal_monotone_sample(keys, w, act, k,
                                                         u=u, device=CPU),
                        names, "given u ")


@pytest.mark.parametrize("case", ["tied6", "all_equal", "dup_u"])
def test_universal_monotone_ties(case):
    """All-equal weights (the saved counterexample and a larger draw) and
    duplicated keys (equal u), exact against the reference."""
    if case == "tied6":
        keys, w, k = np.arange(6, dtype=np.int32), TIED6, 1
    elif case == "all_equal":
        keys, w, k = np.arange(500, dtype=np.int32), np.ones(500,
                                                             np.float32), 8
    else:
        rng = np.random.default_rng(5)
        keys = rng.integers(0, 60, 400).astype(np.int32)   # repeats: equal u
        w, k = rng.lognormal(0, 1, 400).astype(np.float32), 8
    act = np.ones(len(w), bool)
    ref = C.universal_monotone_sample(keys, w, act, k, seed=0)
    port = T.universal_monotone_sample(keys, w, act, k, seed=0, device=CPU)
    assert_fields_equal(ref, port, ("member", "prob", "aux", "h"))


def test_universal_monotone_estimates_unbiased_and_cv():
    keys, w, act = make_data(np.random.default_rng(1), 400)
    H = np.arange(400) % 3 == 0
    samples = [T.universal_monotone_sample(keys, w, act, 16, seed=s,
                                           device=CPU) for s in range(200)]
    for f in (T.SUM, T.COUNT, T.thresh(2.0), T.cap(1.0), T.moment(1.5)):
        ex = float(T.exact(f, w, act, H, device=CPU))
        ests = [float(T.estimate(f, w, s.prob, s.member, H))
                for s in samples]
        assert abs(np.mean(ests) / ex - 1) < 0.11, f.name
        full = float(T.exact(f, w, act, device=CPU))
        cv = np.std([float(T.estimate(f, w, s.prob, s.member))
                     for s in samples[:150]]) / full
        assert cv <= T.cv_bound(1.0, 16) * 1.25, f.name


# ------------------------------------------------------ universal capping
@pytest.mark.parametrize("scheme", ["priority", "ppswor"])
@pytest.mark.parametrize("k", [2, 8])
def test_universal_capping_matches(scheme, k):
    """Under priority r = u, so every field is exact. Under ppswor r/w
    differs from XLA's by a few ulp; the integer fields are exact when no
    two active keys' r/w lie within that window (asserted), probs within
    PROB_ULP."""
    keys, w, act = make_data(np.random.default_rng(k), 250)
    u = np.asarray(C.uniform01(keys, 3))
    if scheme == "ppswor":
        assert rw_gap_ok(np.asarray(C.ppswor_rank(u)), w, act & (w > 0))
    ref = C.universal_capping_sample(keys, w, act, k, m_cap=250,
                                     scheme=scheme, seed=3)
    port = T.universal_capping_sample(keys, w, act, k, m_cap=250,
                                      scheme=scheme, seed=3, device=CPU)
    oref = C.universal_capping_ref(w, u, act, k, scheme)
    oport = T.universal_capping_ref(w, u, act, k, scheme, device=CPU)
    for a, b in ((ref, port), (oref, oport), (oref, port)):
        assert_fields_equal(a, b, ("member", "aux", "hl"))
        if scheme == "priority":
            assert_fields_equal(a, b, ("prob",))
        else:
            assert_ulp(a.prob, b.prob, PROB_ULP, "prob")


def test_capping_subset_of_monotone_and_size_bounds():
    n, k = 1000, 8
    keys, w, act = make_data(np.random.default_rng(2), n)
    sizes_m, sizes_c = [], []
    for s in range(12):
        u = to_np(T.uniform01(keys, s))
        mono = T.universal_monotone_sample(keys, w, act, k, seed=s,
                                           device=CPU)
        capg = T.universal_capping_sample(keys, w, act, k, m_cap=n, seed=s,
                                          device=CPU)
        assert bool(torch.all(capg.member <= mono.member))
        cref = T.universal_capping_ref(w, u, act, k, device=CPU)
        assert bool(torch.equal(capg.member, cref.member))
        sizes_m.append(int(mono.member.sum()))
        sizes_c.append(int(capg.member.sum()))
    assert np.mean(sizes_m) <= T.expected_size_bound(n, k)          # Thm 5.1
    assert np.mean(sizes_c) <= T.capping_size_bound(
        k, w[act].max(), w[act].min())                               # Thm 6.1
    assert np.mean(sizes_c) < np.mean(sizes_m)
    assert T.capping_size_bound(16, 10.0, 0.1) == C.capping_size_bound(
        16, 10.0, 0.1)


# ---------------------------------------------------------------- merging
SKETCH_FIELDS = ("keys", "weights", "probs", "member", "valid")


def test_build_and_merge_match_reference():
    n, k = 600, 8
    keys, w, act = make_data(np.random.default_rng(3), n)
    cap = C.sketch_capacity(n, k)
    assert T.sketch_capacity(n, k) == cap
    parts = np.array_split(np.arange(n), 4)
    rs = [C.build_sketch(keys[p], w[p], act[p], k, cap, seed=3)
          for p in parts]
    ps = [T.build_sketch(keys[p], w[p], act[p], k, cap, seed=3, device=CPU)
          for p in parts]
    for a, b in zip(rs, ps):
        assert_fields_equal(a, b, SKETCH_FIELDS, "build ")
    rm, pm = rs[0], ps[0]
    for a, b in zip(rs[1:], ps[1:]):
        rm, pm = C.merge_sketches(rm, a), T.merge_sketches(pm, b)
        assert_fields_equal(rm, pm, SKETCH_FIELDS, "merge ")
    many = T.merge_many(torch.stack([p.keys for p in ps]),
                        torch.stack([p.weights for p in ps]),
                        torch.stack([p.valid for p in ps]), k, cap, 3)
    rmany = C.merge_many(jnp.stack([r.keys for r in rs]),
                         jnp.stack([r.weights for r in rs]),
                         jnp.stack([r.valid for r in rs]), k, cap, 3)
    assert_fields_equal(rmany, many, SKETCH_FIELDS, "merge_many ")
    np.testing.assert_allclose(float(C.sketch_estimate(rm, C.SUM)),
                               float(T.sketch_estimate(pm, T.SUM)),
                               rtol=EST_RTOL)
    seg = lambda kk: kk % 3 == 0                      # noqa: E731
    np.testing.assert_allclose(
        float(C.sketch_estimate(rm, C.COUNT, seg)),
        float(T.sketch_estimate(pm, T.COUNT, seg)), rtol=EST_RTOL)


def _member_set(sk):
    return {(int(a), float(b), float(p)) for a, b, p, m, v in
            zip(to_np(sk.keys), to_np(sk.weights), to_np(sk.probs),
                to_np(sk.member), to_np(sk.valid)) if v and m}


@pytest.mark.parametrize("draw", range(6))
def test_merge_associative_order_free_and_whole(draw):
    """Forward fold == reverse fold == one sketch of the whole data
    (members exact), on seeded draws and the saved all-tied one."""
    rng = np.random.default_rng(100 + draw)
    if draw == 0:
        w, k, seed, nparts = TIED6, 1, 0, 2
    else:
        w = rng.uniform(2 ** -10, 2 ** 14, rng.integers(4, 120)).astype(
            np.float32)
        k, seed, nparts = int(rng.integers(2, 9)), int(rng.integers(1000)), \
            int(rng.integers(2, 6))
    n = len(w)
    keys = np.arange(n, dtype=np.int32)
    act = np.ones(n, bool)
    cap = T.sketch_capacity(n, k)
    parts = [p for p in np.array_split(np.arange(n), min(nparts, n))
             if len(p)]
    sks = [T.build_sketch(keys[p], w[p], act[p], k, cap, seed=seed,
                          device=CPU) for p in parts]
    fwd = sks[0]
    for s in sks[1:]:
        fwd = T.merge_sketches(fwd, s)
    rev = sks[-1]
    for s in reversed(sks[:-1]):
        rev = T.merge_sketches(rev, s)
    whole = T.build_sketch(keys, w, act, k, cap, seed=seed, device=CPU)
    assert _member_set(fwd) == _member_set(rev) == _member_set(whole)


def test_merge_dedups_max_weight_and_donate_is_identical():
    keys = np.array([1, 2, 3, 4], np.int32)
    act = np.ones(4, bool)
    a = T.build_sketch(keys, np.array([1., 5., 2., 1.], np.float32), act, 4,
                       16, seed=0, device=CPU)
    b = T.build_sketch(keys, np.array([3., 1., 2., 8.], np.float32), act, 4,
                       16, seed=0, device=CPU)
    m = T.merge_sketches(a, b)
    got = {int(kk): float(ww) for kk, ww, v in
           zip(m.keys, m.weights, m.valid) if v}
    assert got[1] == 3. and got[2] == 5. and got[4] == 8.
    a_copy = a._replace(**{f: getattr(a, f).clone()
                           for f in SKETCH_FIELDS})
    d = T.merge_sketches(a_copy, b, donate=True)
    assert d.keys.data_ptr() == a_copy.keys.data_ptr()   # a's slab reused
    for f in SKETCH_FIELDS:
        assert torch.equal(getattr(m, f), getattr(d, f)), f
    with pytest.raises(AssertionError):
        T.merge_sketches(a, b._replace(seed=1))


def test_sketch_interop_round_trip_and_reference_merge():
    """A reference Sketch carried into the port and merged there equals the
    reference's own merge; the port's sketch carried back is exact."""
    n, k = 500, 8
    keys, w, act = make_data(np.random.default_rng(9), n)
    cap = C.sketch_capacity(n, k)
    ra = C.build_sketch(keys[:250], w[:250], act[:250], k, cap, seed=4)
    rb = C.build_sketch(keys[250:], w[250:], act[250:], k, cap, seed=4)
    fields = lambda s: [np.asarray(getattr(s, f))       # noqa: E731
                        for f in SKETCH_FIELDS] + [s.k, s.seed]
    pa = interop.sketch_from_arrays(fields(ra), device=CPU)
    pb = interop.sketch_from_arrays(fields(rb), device=CPU)
    assert pa.k == k and pa.seed == 4 and pa.keys.dtype == torch.int32
    pm = T.merge_sketches(pa, pb)
    rm = C.merge_sketches(ra, rb)
    assert_fields_equal(rm, pm, SKETCH_FIELDS)
    back = interop.sketch_to_arrays(pm)
    assert tuple(back[5:]) == (k, 4)
    for x, y in zip(back[:5], fields(rm)[:5]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        interop.sketch_from_arrays(fields(ra)[:5], device=CPU)


# -------------------------------------------------- property invariants
def _draw(i):
    rng = np.random.default_rng(200 + i)
    w = rng.uniform(2 ** -10, 2 ** 14, rng.integers(4, 120)).astype(
        np.float32)
    if i % 3 == 0:
        w[: len(w) // 2] = w[0]                       # a large tie group
    return w, int(rng.integers(1, 13)), int(rng.integers(0, 10_000))


@pytest.mark.parametrize("i", range(6))
def test_monotone_membership_and_bottomk_containment(i):
    """Lemma 5.1 (x in S^(M,k) <=> h_x < k) and Lemma 5.2 (S^(M,k)
    contains the bottom-k sample of any monotone f) on the port."""
    w, k, seed = _draw(i)
    n = len(w)
    keys = np.arange(n, dtype=np.int32)
    act = np.ones(n, bool)
    u = to_np(T.uniform01(keys, seed))
    h = ((w[None, :] >= w[:, None]) & (u[None, :] < u[:, None])).sum(1)
    s = T.universal_monotone_sample(keys, w, act, k, seed=seed, device=CPU)
    np.testing.assert_array_equal(to_np(s.member), h < k)
    p, m = to_np(s.prob), to_np(s.member)
    assert np.all(p[m] > 0) and np.all(p[m] <= 1.0) and np.all(p[~m] == 0)
    med = float(np.median(w))
    for f in (T.SUM, T.COUNT, T.thresh(med), T.cap(med), T.moment(2.0)):
        ded = T.bottomk_sample(keys, w, act, f, min(k, 8), seed=seed,
                               device=CPU)
        assert bool(torch.all(ded.member <= s.member)), f.name


@pytest.mark.parametrize("i", range(4))
def test_capping_membership_iff_hl_less_k(i):
    """Lemma 6.3 on the port: first-principles h + l < k."""
    rng = np.random.default_rng(300 + i)
    w = rng.uniform(0.5, 100, rng.integers(8, 64)).astype(np.float32)
    k, seed = int(rng.integers(1, 7)), int(rng.integers(0, 500))
    n = len(w)
    keys = np.arange(n, dtype=np.int32)
    act = np.ones(n, bool)
    u = to_np(T.uniform01(keys, seed))
    r = to_np(T.ppswor_rank(torch.from_numpy(u)))
    h = ((w[None, :] >= w[:, None]) & (u[None, :] < u[:, None])).sum(1)
    rw = r / w
    l = ((w[None, :] < w[:, None]) & (rw[None, :] < rw[:, None])).sum(1)
    for s in (T.universal_capping_ref(w, u, act, k, device=CPU),
              T.universal_capping_sample(keys, w, act, k, m_cap=n,
                                         seed=seed, device=CPU)):
        np.testing.assert_array_equal(to_np(s.member), (h + l) < k)
