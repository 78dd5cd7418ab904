"""Parity of the port's metric tier (``repro_torch.core.costs``,
``core.metric_domains``, ``kernels.servicecost`` and ``launch.cluster``)
with the JAX package, on the CPU at small sizes.

The same numpy inputs go through both packages; the reference's K5 runs in
Pallas interpret mode, as its own tests run it, and the port's wrapper
takes its plain version for CPU tensors. Tolerances (``tests/torch_parity``):
encodings exact, squared distances within SQDIST_EPS eps32 of the scale,
cost estimates rtol 1e-5, ball estimates only within the HT weight of the
slots whose d2 lies within that tolerance of r^2, anchor weights within
stated ulps, and within the port bit-identical. Mirrors
``tests/test_cluster.py``, ``tests/test_metric_domains.py`` and the
ClusterEngine hand-off test of ``tests/test_pool_scaleout.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

import repro.core as C                                        # noqa: E402
import repro_torch.core as T                                  # noqa: E402
from repro.core import costs as RCO                           # noqa: E402
from repro.core import metric_domains as RMD                  # noqa: E402
from repro.kernels.servicecost import service_cost_slab as ref_slab  # noqa
from repro.launch import cluster as RCL                       # noqa: E402
from repro_torch import interop                               # noqa: E402
from repro_torch.core import metric_domains as PMD            # noqa: E402
from repro_torch.kernels.servicecost import service_cost_slab  # noqa: E402
from repro_torch.launch import cluster as PCL                 # noqa: E402
from tests.torch_parity import (ANCHOR_EPS_ULP, ANCHOR_NORM_ULP,  # noqa
                                ANCHOR_V_ULP, EST_RTOL, POW_ULP,
                                PROB_ULP, assert_metric_slab_parity,
                                assert_slabs_bitsame, assert_ulp,
                                ball_flip_bound, exact_sq_dists,
                                sq_dist_tol, to_np)

CPU = torch.device("cpu")


def _points(n=400, dim=3, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    ctrs = rng.normal(0, spread, (4, dim))
    return (ctrs[rng.integers(0, 4, n)]
            + rng.normal(0, 0.7, (n, dim))).astype(np.float32)


_ENGINES = {}


def _engines(scheme):
    """(reference engine, port engine) fitted on the same points."""
    if scheme not in _ENGINES:
        X = _points()
        _ENGINES[scheme] = (
            RCL.ClusterEngine.fit(X, k=48, mu=2.0, scheme=scheme, seed=3),
            PCL.ClusterEngine.fit(X, k=48, mu=2.0, scheme=scheme, seed=3,
                                  device="cpu"))
    return _ENGINES[scheme]


def _queries(q, mu, dim=3, seed=1):
    """q queries cycling through ragged cost sets and ball rows (the
    reference's encoding)."""
    rng = np.random.default_rng(seed)
    X = _points(seed=0)
    out = []
    for i in range(q):
        m = int(rng.integers(1, 6))
        ctr = X[rng.integers(0, X.shape[0], m)] + rng.normal(0, 0.1, (m, dim))
        if i % 4 == 3:
            out.append(C.ball_query(ctr, radius=float(rng.random() * 5)))
        else:
            out.append(C.cost_query(ctr, mu=mu))
    return C.encode_cost_queries(out)


def _pt(table):
    """A reference CostTable as the port's (the same numpy arrays)."""
    return T.CostTable(*table)


def _slab_np(eng):
    return tuple(np.asarray(x) for x in eng.sample())


def _slab_t(slab):
    pts, probs, member = slab
    return (torch.from_numpy(pts.copy()), torch.from_numpy(probs.copy()),
            torch.from_numpy(member.copy()))


def assert_estimates(got, want, slab, table, point_weights=None,
                     what=""):
    """Cost rows within EST_RTOL (the sums run in another order); ball rows
    within that rtol plus the HT weight of the slots whose d2 lies within
    the sq_dists tolerance of r^2 (``ball_flip_bound``)."""
    got, want = np.asarray(to_np(got)), np.asarray(to_np(want))
    assert got.shape == want.shape
    pts, probs, member = slab
    for i in range(got.shape[0]):
        if int(table.mode[i]) == C.MODE_BALL:
            bound = ball_flip_bound(pts, probs, member, table.centers[i],
                                    table.cvalid[i], table.param[i],
                                    point_weights)
            slack = bound + EST_RTOL * abs(float(want[i])) + 1e-6
            assert abs(float(got[i]) - float(want[i])) <= slack, (
                what, i, got[i], want[i], bound)
        else:
            np.testing.assert_allclose(got[i], want[i], rtol=EST_RTOL,
                                       atol=1e-6, err_msg=f"{what} row {i}")


# ------------------------------------------------ wire format
def test_encode_pad_and_cost_table_match_reference():
    rng = np.random.default_rng(3)
    sets = [rng.normal(0, 1, (m, 4)).astype(np.float32) for m in (1, 3, 2)]
    qs_r = [C.cost_query(sets[0], 1.0), C.ball_query(sets[1], 2.5),
            C.cost_query(sets[2], 1.5)]
    qs_p = [T.cost_query(sets[0], 1.0), T.ball_query(sets[1], 2.5),
            T.cost_query(sets[2], 1.5)]
    pairs = [(C.encode_cost_queries(qs_r), T.encode_cost_queries(qs_p)),
             (C.encode_cost_queries(qs_r, cmax=5),
              T.encode_cost_queries(qs_p, cmax=5)),
             (C.pad_cost_table(C.encode_cost_queries(qs_r), 16),
              T.pad_cost_table(T.encode_cost_queries(qs_p), 16)),
             (C.cost_table(sets, 2.0), T.cost_table(sets, 2.0))]
    block = rng.normal(0, 1, (5, 3, 4)).astype(np.float32)
    pairs.append((C.cost_table(block, 2.0), T.cost_table(block, 2.0)))
    for r, p in pairs:
        for name, a, b in zip(r._fields, r, p):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
    one = T.encode_cost_queries(qs_p[0])
    assert T.encode_cost_queries(one) is one
    assert T.pad_cost_table(one, 1) is one


def test_encode_cost_queries_validation():
    with pytest.raises(ValueError):
        T.encode_cost_queries([])
    with pytest.raises(ValueError):
        T.encode_cost_queries([T.cost_query(np.zeros((2, 3))),
                               T.cost_query(np.zeros((2, 4)))])
    with pytest.raises(ValueError):
        T.encode_cost_queries([T.cost_query(np.zeros((4, 3)))], cmax=2)
    t = T.encode_cost_queries([T.cost_query(np.zeros((1, 3))),
                               T.cost_query(np.zeros((4, 3)))])
    assert t.centers.shape == (2, 4, 3)
    assert t.cvalid.sum() == 5


# ------------------------------------------------ distances and values
@pytest.mark.parametrize("n,m,dim,scale", [(400, 5, 3, 6.0),
                                           (300, 4, 2, 10.0),
                                           (512, 20, 68, 8.0)])
def test_sq_dists_within_tolerance(n, m, dim, scale):
    rng = np.random.default_rng(n + dim)
    x = rng.normal(0, scale, (n, dim)).astype(np.float32)
    c = rng.normal(0, scale, (m, dim)).astype(np.float32)
    c[0] = x[7]                                   # a zero distance
    ref = np.asarray(RCO.sq_dists(c, x), np.float64)
    port = T.costs.sq_dists(torch.from_numpy(c), torch.from_numpy(x))
    port = port.numpy().astype(np.float64)
    tol = sq_dist_tol(c, x)
    assert np.all(np.abs(ref - port) <= tol)
    assert np.all(np.abs(port - exact_sq_dists(c, x)) <= tol)
    assert port.min() >= 0.0


def _value_tol(d2, tol, mu):
    """Bound on |v_ref - v_port| for v = d2^(mu/2) when the d2 differ by
    at most ``tol``: |a^e - b^e| <= |a - b|^e for e <= 1, else
    e max(a, b)^(e-1) |a - b|; plus POW_ULP ulp of the value."""
    e = 0.5 * mu
    hi = d2 + tol
    prop = tol ** e if e <= 1 else e * hi ** (e - 1) * tol
    return prop + POW_ULP * np.spacing(np.float32(hi ** e)).astype(
        np.float64)


@pytest.mark.parametrize("mu", [1.0, 2.0, 1.5])
def test_service_cost_values_and_plain_estimates_match_reference(mu):
    ref_eng, _ = _engines("ppswor")
    slab = _slab_np(ref_eng)
    table = _queries(24, mu)
    ref = np.asarray(C.service_cost_values(slab[0], table), np.float64)
    ptab = T.costs.table_to(table, CPU)
    port = T.service_cost_values(torch.from_numpy(slab[0].copy()), ptab)
    port = port.numpy().astype(np.float64)
    for i in range(table.mu.shape[0]):
        ctr = table.centers[i][table.cvalid[i]]
        d2 = exact_sq_dists(ctr, slab[0]).min(0)
        tol = sq_dist_tol(ctr, slab[0]).max(0)
        if int(table.mode[i]) == C.MODE_BALL:
            flips = ref[i] != port[i]
            near = np.abs(d2 - float(table.param[i]) ** 2) <= tol
            assert not np.any(flips & ~near), i
        else:
            assert np.all(np.abs(ref[i] - port[i])
                          <= _value_tol(d2, tol, mu)), i
    est_r = C.estimate_service_costs(*slab, table, use_kernels=False)
    est_p = T.estimate_service_costs(*_slab_t(slab), _pt(table),
                                     use_kernels=False)
    assert_estimates(est_p, est_r, slab, table, what="plain")


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("q", [1, 16, 128])
@pytest.mark.parametrize("mu", [1.0, 2.0])
def test_service_cost_plain_kernel_path_vs_reference_kernel(scheme, q, mu):
    """The port's K5 wrapper on CPU tensors (its plain version) against
    the reference's K5 in interpret mode, on the reference engine's slab,
    over the grid of the reference's kernel-vs-oracle test."""
    ref_eng, _ = _engines(scheme)
    slab = _slab_np(ref_eng)
    table = _queries(q, mu)
    want = np.asarray(ref_slab(*slab, table))
    got = service_cost_slab(*_slab_t(slab), _pt(table))
    assert got.shape == (q,) and got.dtype == torch.float32
    assert_estimates(got, want, slab, table, what=f"{scheme} q={q}")
    assert torch.all(torch.isfinite(got)) and torch.all(got >= 0)


def test_service_cost_weighted_points():
    ref_eng, _ = _engines("ppswor")
    slab = _slab_np(ref_eng)
    pw = np.random.default_rng(5).random(slab[0].shape[0]).astype(
        np.float32)
    table = _queries(8, 2.0)
    want = np.asarray(ref_slab(*slab, table, point_weights=pw))
    got = service_cost_slab(*_slab_t(slab), _pt(table),
                            point_weights=torch.from_numpy(pw))
    assert_estimates(got, want, slab, table, point_weights=pw,
                     what="weighted")
    plain = T.estimate_service_costs(*_slab_t(slab), _pt(table),
                                     point_weights=pw, use_kernels=False)
    assert torch.equal(got, plain)


def test_pad_rows_estimate_exactly_zero():
    _, eng = _engines("ppswor")
    pts, probs, member = eng.sample()
    table = T.pad_cost_table(_pt(_queries(5, 1.0)), 16)
    for uk in (True, False):
        got = T.estimate_service_costs(pts, probs, member, table,
                                       use_kernels=uk)
        assert got.shape == (16,)
        assert torch.equal(got[5:], torch.zeros(11))


# ------------------------------------------------ ball-density edges
def test_ball_density_edge_cases():
    X = _points(seed=2)
    ref = RCL.ClusterEngine.fit(X, k=48, mu=1.0, seed=7)
    eng = PCL.ClusterEngine.fit(X, k=48, mu=1.0, seed=7, device="cpu")
    pts, probs, member = eng.sample()
    diam = float(np.max(np.linalg.norm(X[None] - X[:, None], axis=-1)))

    cover = eng.ball_density(X[0], diam * 1.01)
    assert cover == pytest.approx(eng.total_count(), rel=1e-5)
    assert cover == pytest.approx(ref.ball_density(X[0], diam * 1.01),
                                  rel=EST_RTOL)
    assert eng.total_count() == pytest.approx(ref.total_count(),
                                              rel=EST_RTOL)

    t0 = T.encode_cost_queries([T.ball_query(X[0], 0.0),
                                T.ball_query(X[0] + 100.0, 0.0)])
    k0 = service_cost_slab(pts, probs, member, t0)
    x0 = T.estimate_service_costs(pts, probs, member, t0, use_kernels=False)
    assert torch.equal(k0, x0)
    assert torch.all(torch.isfinite(k0)) and torch.all(k0 >= 0)
    assert float(k0[1]) == 0.0
    assert float(k0[0]) <= eng.total_count() + 1e-3

    te = T.CostTable(centers=np.zeros((1, 2, X.shape[1]), np.float32),
                     cvalid=np.zeros((1, 2), bool),
                     mu=np.ones(1, np.float32), param=np.ones(1, np.float32),
                     mode=np.array([T.MODE_BALL], np.int32))
    assert float(service_cost_slab(pts, probs, member, te)[0]) == 0.0


def test_ball_density_monotone_in_radius():
    _, eng = _engines("ppswor")
    q = _points(seed=0)[0]
    ests = [eng.ball_density(q, r) for r in (0.5, 1.5, 4.0, 50.0)]
    assert all(a <= b + 1e-4 for a, b in zip(ests, ests[1:]))


# ------------------------------------------------ engine: streaming state
def test_cluster_engine_streaming_matches_reference():
    X = _points(n=500, seed=4)
    ref = RCL.ClusterEngine(dim=3, k=48, mu=2.0, seed=1)
    eng = PCL.ClusterEngine(dim=3, k=48, mu=2.0, seed=1, device="cpu")
    for i in range(3):
        ref.absorb(X[i::3])
        eng.absorb(X[i::3])
        assert_metric_slab_parity(ref._sketch, eng._sketch,
                                  f"absorb {i}: ")
        np.testing.assert_array_equal(np.asarray(ref._coords),
                                      eng._coords.numpy())
    assert eng.epoch == ref.epoch == 3
    assert eng.merge_stats == ref.merge_stats
    keys = eng._sketch.keys.numpy()
    coords = eng._coords.numpy()
    order = np.concatenate([np.arange(500)[i::3] for i in range(3)])
    for s in np.nonzero(eng._sketch.valid.numpy())[0]:
        np.testing.assert_array_equal(coords[s], X[order[keys[s]]])
    est = eng.clustering_cost(X[:4])
    exact = float(T.exact_service_costs(X, T.cost_query(X[:4], 2.0),
                                        device="cpu")[0])
    assert est == pytest.approx(exact, rel=0.5)
    assert est == pytest.approx(ref.clustering_cost(X[:4]), rel=EST_RTOL)
    assert exact == pytest.approx(
        float(C.exact_service_costs(X, C.cost_query(X[:4], 2.0))[0]),
        rel=EST_RTOL)


def test_align_coords_delta_equals_full_lookup():
    rng = np.random.default_rng(2)
    old_keys = torch.tensor([5, 9, -1, 2, 7, -1], dtype=torch.int32)
    old_coords = torch.from_numpy(rng.normal(0, 1, (6, 3)).astype(
        np.float32))
    old_coords[old_keys < 0] = 0.0
    chunk_keys = torch.tensor([11, 3, -1, -1], dtype=torch.int32)
    chunk_coords = torch.from_numpy(rng.normal(0, 1, (4, 3)).astype(
        np.float32))
    new_keys = torch.tensor([5, 3, 9, 11, -1, 2], dtype=torch.int32)
    delta = PCL._align_coords_delta(new_keys, old_keys, old_coords,
                                    chunk_keys, chunk_coords)
    full = PCL._align_coords(new_keys, torch.cat([old_keys, chunk_keys]),
                             torch.cat([old_coords, chunk_coords]))
    assert torch.equal(delta, full)
    want = RCL._align_coords(jnp.asarray(new_keys.numpy()),
                             jnp.asarray(np.concatenate(
                                 [old_keys.numpy(), chunk_keys.numpy()])),
                             jnp.asarray(np.concatenate(
                                 [old_coords.numpy(),
                                  chunk_coords.numpy()])))
    np.testing.assert_array_equal(np.asarray(want), full.numpy())


def test_cluster_engine_sample_survives_absorb():
    rng = np.random.default_rng(9)
    eng = PCL.ClusterEngine(dim=2, k=32, seed=0, device="cpu")
    eng.absorb(rng.normal(0, 1, (200, 2)).astype(np.float32))
    coords, probs, member = eng.sample()
    held = [x.clone() for x in (coords, probs, member)]
    eng.absorb(rng.normal(0, 1, (200, 2)).astype(np.float32))
    for a, b in zip(held, (coords, probs, member)):
        assert torch.equal(a, b)
    assert coords.shape == eng.sample()[0].shape
    assert not torch.equal(probs, eng.sample()[1])


def test_service_costs_q_chunking_matches_one_shot():
    """Q past the per-launch ceiling is split transparently; each row is
    bit-identical to the one-shot batch within the port, and within rtol
    of the reference's XLA batch."""
    ref_eng, eng = _engines("ppswor")
    table = _queries(150, 2.0)
    one_shot = eng.service_costs(_pt(table))
    eng.q_max = 32
    try:
        got = eng.service_costs(_pt(table))
    finally:
        eng.q_max = 128
    np.testing.assert_array_equal(got, one_shot)
    slab = _slab_np(ref_eng)
    want = np.asarray(C.estimate_service_costs(*slab, table,
                                               use_kernels=False))
    assert got.dtype == np.float32 and got.shape == (150,)
    assert_estimates(got, want, slab, table, what="chunked")


def test_cluster_engine_explicit_keys_never_collide_with_default():
    rng = np.random.default_rng(13)
    eng = PCL.ClusterEngine(dim=2, k=32, seed=0, device="cpu")
    X1 = rng.normal(0, 1, (100, 2)).astype(np.float32)
    X2 = rng.normal(5, 1, (100, 2)).astype(np.float32)
    eng.absorb(X1, keys=np.arange(40, 140))
    eng.absorb(X2)                                  # must start at key 140
    valid = eng._sketch.valid.numpy()
    keys = eng._sketch.keys.numpy()[valid]
    coords = eng._coords.numpy()[valid]
    both = np.concatenate([X1, X2])
    lookup = {40 + i: both[i] for i in range(200)}
    for ky, co in zip(keys, coords):
        np.testing.assert_array_equal(co, lookup[int(ky)])


def test_local_search_zero_rounds_returns_scored_init():
    _, eng = _engines("ppswor")
    res = PCL.local_search(eng, k=3, rounds=0, n_cand=8)
    assert res.rounds == 0 and len(res.history) == 1
    assert res.est_cost == pytest.approx(
        float(eng.service_costs(T.cost_query(res.centers, eng.mu))[0]),
        rel=1e-6)


def test_absorb_grows_count_and_overflow_matches_reference():
    rng = np.random.default_rng(0)
    chunks = [rng.normal(0, 1, (200, 2)).astype(np.float32)
              for _ in range(3)]
    ref = RCL.ClusterEngine(dim=2, k=32, seed=0)
    eng = PCL.ClusterEngine(dim=2, k=32, seed=0, device="cpu")
    assert eng.total_count() == 0.0 and not eng.overflow
    counts = []
    for ch in chunks:
        ref.absorb(ch)
        eng.absorb(ch)
        counts.append(eng.total_count())
        assert counts[-1] == pytest.approx(ref.total_count(), rel=EST_RTOL)
        assert eng.overflow == ref.overflow
    assert counts[0] < counts[1] < counts[2]
    assert eng.epoch == 3
    assert eng.merge_stats["bytes_resident"] == ref.merge_stats[
        "bytes_resident"]


# ------------------------------------------------ optimizer vs reference
@pytest.mark.parametrize("inst,mu", [(0, 2.0), (1, 1.0), (2, 2.0)])
def test_local_search_matches_reference_on_small_instances(inst, mu):
    """The same search in both packages: the same centers, the history
    within rtol 1e-5, for the sample scorer and the exact scorer; and the
    reference's acceptance bound on the port's result."""
    X = _points(n=300, dim=2, seed=10 + inst, spread=7.0)
    ref = RCL.ClusterEngine.fit(X, k=64, mu=mu, seed=inst)
    eng = PCL.ClusterEngine.fit(X, k=64, mu=mu, seed=inst, device="cpu")
    for kw_r, kw_p in (({}, {}),
                       ({"scorer": RCL.exact_scorer(X)},
                        {"scorer": PCL.exact_scorer(X, device="cpu")})):
        r = RCL.local_search(ref, k=3, mu=mu, rounds=10, n_cand=16, **kw_r)
        p = PCL.local_search(eng, k=3, mu=mu, rounds=10, n_cand=16, **kw_p)
        np.testing.assert_array_equal(p.centers, r.centers)
        assert p.rounds == r.rounds
        np.testing.assert_allclose(p.history, r.history, rtol=EST_RTOL)
        if not kw_p:
            res_s = p
        else:
            res_e = p
    ex = [float(T.exact_service_costs(X, T.cost_query(res.centers, mu),
                                      device="cpu")[0])
          for res in (res_s, res_e)]
    bound = 3.0 * T.cv_bound(1.0, eng.k)
    assert ex[0] <= ex[1] * (1.0 + bound) + 1e-6
    assert res_s.est_cost == pytest.approx(ex[0], rel=bound)
    assert all(a >= b for a, b in zip(res_s.history, res_s.history[1:]))


def test_kcenter_matches_reference_and_covers_sample():
    X = _points(n=400, dim=2, seed=20, spread=10.0)
    ref = RCL.kcenter(RCL.ClusterEngine.fit(X, k=64, mu=1.0, seed=0), 4)
    kc = PCL.kcenter(PCL.ClusterEngine.fit(X, k=64, mu=1.0, seed=0,
                                           device="cpu"), 4)
    assert kc.centers.shape == (4, 2)
    np.testing.assert_array_equal(kc.centers, ref.centers)
    assert kc.radius == pytest.approx(ref.radius, rel=1e-5)
    assert kc.coverage_est == pytest.approx(kc.total_est, rel=1e-5)
    assert kc.total_est == pytest.approx(ref.total_est, rel=EST_RTOL)
    assert kc.coverage_est == pytest.approx(ref.coverage_est, rel=EST_RTOL)
    assert kc.radius < 6.0


def test_local_search_on_empty_engine_raises():
    eng = PCL.ClusterEngine(dim=2, k=8, device="cpu")
    with pytest.raises(ValueError, match="empty sample"):
        PCL.local_search(eng, k=2)
    assert eng.service_costs(T.cost_query(np.zeros((1, 2)), 2.0))[0] == 0.0


# ------------------------------------------------ metric domains
@pytest.mark.parametrize("seed", [0, 1, 6])
def test_farthest_point_anchors_match_reference(seed):
    """Anchors exact; d_min within the sq_dists tolerance through the
    sqrt (the reference's own jit-vs-host-loop bitwise test is unsteady
    on JAX 0.9.0)."""
    X = _points(n=200, seed=seed)
    ra, rd = RMD.farthest_point_anchors(X, 8)
    pa, pd = T.farthest_point_anchors(torch.from_numpy(X), 8)
    assert pa.dtype == torch.int32
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    A = X[pa.numpy()]
    tol = np.sqrt(sq_dist_tol(A, X).max(0))
    assert np.all(np.abs(pd.numpy() - np.asarray(rd)) <= tol)
    # the host loop of the reference's test, in the port: bit-identical
    d_min = PMD._pairwise_dist(torch.from_numpy(X),
                               torch.from_numpy(X[:1])).reshape(-1)
    for a in pa.numpy()[1:]:
        d_min = torch.minimum(d_min, PMD._pairwise_dist(
            torch.from_numpy(X), torch.from_numpy(X[a:a + 1])).reshape(-1))
    assert torch.equal(d_min, pd)


@pytest.mark.parametrize("mu", [1.0, 2.0, 1.5])
def test_anchor_upper_weights_and_fold_match_reference(mu):
    X = _points(n=400, seed=4)
    A = X[np.asarray(RMD.farthest_point_anchors(X, 8)[0])]
    rv, reps, rnorm = RMD.anchor_upper_weights(X, A, mu)
    pv, peps, pnorm = T.metric_domains.anchor_upper_weights(
        torch.from_numpy(X), torch.from_numpy(A), mu)
    assert_ulp(reps, peps, ANCHOR_EPS_ULP, "eps")
    assert_ulp(rnorm, pnorm, ANCHOR_NORM_ULP, "norm")
    assert_ulp(rv, pv, ANCHOR_V_ULP, "v")
    # frozen normalizers, as a streaming engine passes them
    rv2, _, _ = RMD.anchor_upper_weights(X[:50], A, mu, eps=reps,
                                         norm=rnorm)
    pv2, _, _ = T.metric_domains.anchor_upper_weights(
        torch.from_numpy(X[:50]), torch.from_numpy(A), mu,
        eps=torch.from_numpy(np.array(reps)),
        norm=torch.from_numpy(np.array(rnorm)))
    assert_ulp(rv2, pv2, ANCHOR_V_ULP, "v (frozen)")
    # the reference's v through the port's fold isolates the fold
    spec_r = C.MultiSketchSpec(((C.SUM, 48),), "ppswor", 2)
    spec_p = T.MultiSketchSpec(((T.SUM, 48),), "ppswor", 2)
    keys = np.arange(400, dtype=np.int32)
    v = np.array(rv, np.float32)
    ref = C.multisketch_absorb(C.multisketch_empty(spec_r), keys, v,
                               np.ones(400, bool), spec=spec_r)
    port = T.multisketch_absorb(T.multisketch_empty(spec_p, device="cpu"),
                                keys, v, np.ones(400, bool), spec=spec_p)
    for name in ("keys", "member", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(port, name).numpy(),
                                      err_msg=name)
    assert_ulp(ref.probs, port.probs, PROB_ULP, "probs")


def test_metric_sample_sketch_matches_reference():
    X = _points(n=300, seed=8)
    rms, rspec = RMD.metric_sample_sketch(X, 24, mu=1.0, seed=5)
    pms, pspec = T.metric_sample_sketch(X, 24, mu=1.0, seed=5, device="cpu")
    assert (pspec.objectives[0][1], pspec.seed, pspec.scheme) == (
        rspec.objectives[0][1], rspec.seed, rspec.scheme)
    np.testing.assert_array_equal(pms.anchors.numpy(),
                                  np.asarray(rms.anchors))
    for name in ("keys", "member", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(rms.sketch, name)),
                                      getattr(pms.sketch, name).numpy(),
                                      err_msg=name)
    assert_ulp(rms.sketch.probs, pms.sketch.probs, PROB_ULP, "probs")
    np.testing.assert_array_equal(pms.coords.numpy(), np.asarray(rms.coords))
    rs = C.universal_metric_sample(X, 24, seed=5)
    ps = T.universal_metric_sample(X, 24, seed=5, device="cpu")
    np.testing.assert_array_equal(ps.member.numpy(), np.asarray(rs.member))
    assert_ulp(rs.prob, ps.prob, PROB_ULP, "prob")
    q = X[3] + 0.1
    assert float(T.estimate_centrality(ps, X, q)) == pytest.approx(
        float(C.estimate_centrality(rs, X, q)), rel=EST_RTOL)
    for r in (1.0, 3.0):
        assert float(T.estimate_ball_density(ps, X, q, r)) == \
            pytest.approx(float(C.estimate_ball_density(rs, X, q, r)),
                          rel=EST_RTOL)


def test_metric_sample_is_sketch_backed():
    X = _points(n=300, seed=8)
    s = T.universal_metric_sample(X, 24, seed=5, device="cpu")
    ms, spec = T.metric_sample_sketch(X, 24, seed=5, device="cpu")
    assert spec.seed == 5 and spec.scheme == "ppswor"
    sk = ms.sketch
    keys = sk.keys.numpy()
    member_slots = sk.member.numpy() & sk.valid.numpy()
    dense = np.zeros(300, bool)
    dense[keys[member_slots]] = True
    np.testing.assert_array_equal(s.member.numpy(), dense)
    assert np.all((s.prob.numpy() > 0) == dense)
    np.testing.assert_array_equal(ms.coords.numpy()[member_slots],
                                  X[keys[member_slots]])


@pytest.fixture(scope="module")
def metric_points():
    # clustered points: the regime of tests/test_metric_domains.py
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 5, (5, 3))
    return (centers[rng.integers(0, 5, 600)]
            + rng.normal(0, 0.7, (600, 3))).astype(np.float32)


@pytest.fixture(scope="module")
def metric_samples(metric_points):
    return [T.universal_metric_sample(metric_points, 48, seed=s,
                                      device="cpu") for s in range(60)]


def test_centrality_unbiased_for_many_queries(metric_points, metric_samples):
    k = 48
    queries = np.random.default_rng(1).normal(0, 5, (6, 3)).astype(
        np.float32)
    for q in queries:
        exact = float(np.sum(np.linalg.norm(metric_points - q, axis=1)))
        ests = [float(T.estimate_centrality(s, metric_points, q))
                for s in metric_samples]
        assert abs(np.mean(ests) / exact - 1) < 0.1, q
        assert np.std(ests) / exact < 2.0 / np.sqrt(k - 1)


def test_ball_density_same_sample(metric_points, metric_samples):
    q = metric_points[3] + 0.1
    tested = 0
    for r in (1.0, 3.0, 8.0):
        exact = float(np.sum(np.linalg.norm(metric_points - q, axis=1) <= r))
        if exact < 20:
            continue  # tiny segments: CV bound too loose to test tightly
        ests = [float(T.estimate_ball_density(s, metric_points, q, r))
                for s in metric_samples]
        assert abs(np.mean(ests) / exact - 1) < 0.25, r
        tested += 1
    assert tested >= 1


def test_sample_size_overhead_constant(metric_points):
    """§7: universality overhead is a constant factor over k (not |X|)."""
    for k in (16, 32):
        sizes = [int(T.universal_metric_sample(metric_points, k, seed=s,
                                               device="cpu").member.sum())
                 for s in range(10)]
        assert np.mean(sizes) <= 2.5 * (2.0 ** 1.0) * k


# ------------------------------------------------ hand-off and interop
def test_cluster_engine_handoff_promotes_bit_identical_follower():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 3)).astype(np.float32)
    src = PCL.ClusterEngine(dim=3, k=32, seed=5, chunk=64, device="cpu")
    src.absorb(X[:250])
    follower = PCL.ClusterEngine.from_handoff(src.handoff(), device="cpu")
    q = T.cost_query(X[:4], 2.0)
    np.testing.assert_array_equal(src.service_costs(q),
                                  follower.service_costs(q))
    src.absorb(X[250:])
    follower.absorb(X[250:])
    np.testing.assert_array_equal(src.service_costs(q),
                                  follower.service_costs(q))
    assert_slabs_bitsame(src._sketch, follower._sketch)
    assert torch.equal(src._coords, follower._coords)


def _ref_replica_arrays(rep):
    return dict(sketch=[np.asarray(x) for x in rep.sketch],
                coords=np.asarray(rep.coords),
                anchor_coords=np.asarray(rep.anchor_coords),
                eps=np.asarray(rep.eps), norm=np.asarray(rep.norm),
                next_key=rep.next_key, epoch=rep.epoch, config=rep.config)


def test_reference_replica_promotes_in_the_port_and_back():
    """A reference engine's hand-off, carried through interop, answers
    within rtol 1e-5 in the port and keeps absorbing with keys and member
    exact; the port's replica carried back promotes in the reference."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 3)).astype(np.float32)
    ref = RCL.ClusterEngine(dim=3, k=32, seed=5, chunk=64)
    ref.absorb(X[:250])
    rep = interop.cluster_replica_from_arrays(
        **_ref_replica_arrays(ref.handoff()), device="cpu")
    eng = PCL.ClusterEngine.from_handoff(rep, device="cpu")
    table = _queries(12, 2.0)
    slab = _slab_np(ref)
    assert_estimates(eng.service_costs(_pt(table)),
                     ref.service_costs(table), slab, table, what="promoted")
    ref.absorb(X[250:])
    eng.absorb(X[250:])
    for name in ("keys", "member", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(ref._sketch, name)),
                                      getattr(eng._sketch, name).numpy(),
                                      err_msg=name)
    assert_metric_slab_parity(ref._sketch, eng._sketch, "after absorb: ")
    np.testing.assert_array_equal(eng._coords.numpy(),
                                  np.asarray(ref._coords))

    back = interop.cluster_replica_to_arrays(eng.handoff())
    ref2 = RCL.ClusterEngine.from_handoff(RCL.ClusterReplica(
        sketch=C.MultiSketch(*(jnp.asarray(x) for x in back["sketch"])),
        coords=jnp.asarray(back["coords"]),
        anchor_coords=jnp.asarray(back["anchor_coords"]),
        eps=jnp.asarray(back["eps"]), norm=jnp.asarray(back["norm"]),
        next_key=back["next_key"], epoch=back["epoch"],
        config=back["config"]))
    table = _queries(12, 1.0)
    assert_estimates(ref2.service_costs(table),
                     eng.service_costs(_pt(table)), _slab_np(ref2), table,
                     what="carried back")
    assert ref2.epoch == eng.epoch == 2


def test_interop_replica_before_first_absorb():
    eng = PCL.ClusterEngine(dim=2, k=8, device="cpu")
    back = interop.cluster_replica_to_arrays(eng.handoff())
    assert back["anchor_coords"] is None and back["eps"] is None
    rep = interop.cluster_replica_from_arrays(**back, device="cpu")
    twin = PCL.ClusterEngine.from_handoff(rep, device="cpu")
    assert twin.anchors is None and twin.total_count() == 0.0


# ------------------------------------------------ the card by default
@pytest.mark.parametrize("entry", ["engine", "metric_sample", "exact"])
def test_entry_points_without_device_need_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = _points(n=50)
    call = {"engine": lambda: PCL.ClusterEngine(dim=3),
            "metric_sample": lambda: T.universal_metric_sample(X, 8),
            "exact": lambda: T.exact_service_costs(
                X, T.cost_query(X[:2], 2.0))}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
