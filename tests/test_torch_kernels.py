"""Parity of the port's kernel wrappers (``repro_torch.kernels``) with the
JAX package's Pallas kernels. On the CPU each wrapper runs its kernel's
plain PyTorch version; the reference runs its Pallas kernels in interpret
mode, as its own tests do. The ``gpu`` tests hold each CUDA kernel against
its plain version on the card (tests/test_torch_gpu.py). Tolerances:
tests/torch_parity.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels as RK                                    # noqa: E402
import repro_torch.kernels as K                               # noqa: E402
from repro.core.predicates import encode_predicates as ref_encode  # noqa
import repro.core as C                                        # noqa: E402
from tests.torch_parity import (EST_RTOL, FVAL_ULP, SEED_ULP,  # noqa: E402
                                assert_ulp, to_np)

# kind 0=sum, 1=count, 2=thresh, 3=cap, 4=moment (kernels/seeds.py)
OBJ8 = ((0, 0.0), (1, 0.0), (2, 2.0), (3, 1.5), (4, 1.5), (2, 0.5),
        (3, 4.0), (4, 0.5))


def _inputs(n, seed=0, inactive=0.1):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
    w = rng.lognormal(0, 1.5, n).astype(np.float32)
    w[rng.random(n) < 0.05] = 0.0
    act = rng.random(n) >= inactive
    return keys, w, act


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ----------------------------------------------------------------------- K1
def _check_seeds(keys, w, act, objs, scheme, seed=0):
    rs, rf = RK.fused_seeds_fvals(keys, w, act, objs, scheme, seed)
    ps, pf = K.fused_seeds_fvals(*_t(keys, w, act), objs, scheme, seed)
    assert ps.shape == rs.shape and pf.shape == rf.shape
    for j, (kind, _) in enumerate(objs):
        if scheme == "priority" and kind != 4:
            np.testing.assert_array_equal(np.asarray(rs[j]), to_np(ps[j]))
        assert_ulp(rs[j], ps[j], SEED_ULP, f"seeds[{j}]")
        if kind == 4:
            assert_ulp(rf[j], pf[j], FVAL_ULP, f"fvals[{j}]")
        else:
            np.testing.assert_array_equal(np.asarray(rf[j]), to_np(pf[j]))


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("nf", [1, 3, 8])
def test_fused_seeds_fvals_matches_pallas(scheme, nf):
    _check_seeds(*_inputs(1500, nf), OBJ8[:nf], scheme, seed=nf)


@pytest.mark.parametrize("n,inactive", [(1, 0.0), (3000, 0.0), (700, 1.0)],
                         ids=["n1", "ragged3000", "all_inactive"])
def test_fused_seeds_edge_inputs(n, inactive):
    _check_seeds(*_inputs(n, 5, inactive), OBJ8, "ppswor", seed=9)


def test_fused_seeds_rejects_bogus_scheme_and_counts_no_cpu_launch():
    keys, w, act = _t(*_inputs(10))
    with pytest.raises(ValueError):
        K.fused_seeds_fvals(keys, w, act, OBJ8[:1], "pps")
    before = K.launch_counts()
    K.fused_seeds(keys, w, act, OBJ8[:2])
    assert K.launch_counts() == before       # the plain version ran


@pytest.mark.parametrize("nf", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 3, 5, 4097, 16_402])
def test_fused_seeds_only_matches_pallas_and_keeps_no_fvals(n, nf):
    """The seeds-only mode against the reference's ``fused_seeds`` (Pallas,
    interpret mode): seeds within SEED_ULP, and no f-value array made."""
    keys, w, act = _inputs(n, n + nf)
    objs = OBJ8[:nf]
    rs = RK.fused_seeds(keys, w, act, objs, "ppswor", 7)
    ps = K.fused_seeds(*_t(keys, w, act), objs, "ppswor", 7)
    assert tuple(ps.shape) == tuple(rs.shape) == (nf, n)
    assert_ulp(rs, ps, SEED_ULP, "seeds")
    seeds, fvals = K.seeds.seeds_and_fvals(*_t(keys, w, act), objs,
                                           "ppswor", 7, want_fvals=False)
    assert fvals is None
    assert torch.equal(seeds, ps)


# ----------------------------------------------------------------------- K2
@pytest.mark.parametrize("n,k,nf", [(100, 5, 1), (1500, 64, 3),
                                    (3000, 17, 1), (60, 64, 1)])
def test_batched_block_bottomk_matches_pallas(n, k, nf):
    rng = np.random.default_rng(n)
    s = rng.random((nf, n)).astype(np.float32)
    s[:, ::7] = np.inf
    s[:, 3:40:3] = 0.5                      # ties inside a block
    rv, ri = RK.batched_block_bottomk(s, k)
    pv, pi = K.batched_block_bottomk(*_t(s), k)
    np.testing.assert_array_equal(np.asarray(rv), to_np(pv))
    np.testing.assert_array_equal(np.asarray(ri), to_np(pi))


@pytest.mark.parametrize("n,k", [(3000, 64), (60, 59), (10, 64),
                                 (1, 1), (4, 3)])
def test_batched_bottomk_select_matches_pallas(n, k):
    rng = np.random.default_rng(k)
    s = rng.random((3, n)).astype(np.float32)
    s[1, :n // 2] = np.inf
    if n == 4:
        s[:] = [1.0, 1.0, 1.0, 0.5]         # lax.top_k tie order
    ref = RK.batched_bottomk_select(s, k)
    port = K.batched_bottomk_select(*_t(s), k)
    for name, r, p in zip(("vals", "idx", "tau"), ref, port):
        assert tuple(p.shape) == np.asarray(r).shape, name
        np.testing.assert_array_equal(np.asarray(r), to_np(p), err_msg=name)
    if n == 4:
        np.testing.assert_array_equal(to_np(port[1])[0], [3, 0, 1])


def test_bottomk_1d_views():
    s = np.random.default_rng(1).random(2100).astype(np.float32)
    for r, p in zip(RK.bottomk_select(s, 33), K.bottomk_select(*_t(s), 33)):
        np.testing.assert_array_equal(np.asarray(r), to_np(p))
    for r, p in zip(RK.block_bottomk(s, 9), K.block_bottomk(*_t(s), 9)):
        np.testing.assert_array_equal(np.asarray(r), to_np(p))


# ----------------------------------------------------------------------- K3
def _compact_inputs(n, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(-3, n // 2, n)).astype(np.int32)  # dups, <0
    w = rng.lognormal(0, 1, n).astype(np.float32)
    w[rng.random(n) < 0.1] = 1.0                                  # ties
    member = rng.random(n) < 0.2
    keep = member | (rng.random(n) < 0.05)
    return keys, w, member, keep


@pytest.mark.parametrize("n,cap", [(1500, 64), (40, 64), (3000, 33)])
def test_retention_priority_and_compact_take_match_pallas(n, cap):
    ins = _compact_inputs(n, cap)
    np.testing.assert_array_equal(np.asarray(RK.retention_priority(*ins)),
                                  to_np(K.retention_priority(*_t(*ins))))
    for r, p in zip(RK.compact_take(*ins, cap),
                    K.compact_take(*_t(*ins), cap)):
        np.testing.assert_array_equal(np.asarray(r), to_np(p))


# ----------------------------------------------------------------------- K4
def _slab(c, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40_000, c).astype(np.int32)
    keys[rng.random(c) < 0.1] = -1
    w = rng.lognormal(0, 1.5, c).astype(np.float32)
    p = rng.uniform(0.02, 1.0, c).astype(np.float32)
    m = (rng.random(c) < 0.8) & (keys >= 0)
    return keys, w, p, m


def _table(b, seed):
    rng = np.random.default_rng(seed)
    preds = []
    for i in range(b):
        r = i % 3
        if r == 0:
            lo = int(rng.integers(0, 30_000))
            preds.append(C.key_range(lo, lo + int(rng.integers(0, 20_000))))
        elif r == 1:
            preds.append(C.key_mask(7, int(rng.integers(0, 8))))
        else:
            preds.append(C.hash_fraction(float(rng.uniform(0, 1)),
                                         int(rng.integers(0, 99))))
    return ref_encode(preds)


@pytest.mark.parametrize("b", [1, 16, 128])
@pytest.mark.parametrize("nf", [1, 3, 8])
def test_segment_query_slab_matches_pallas(b, nf):
    slab = _slab(300, b + nf)
    table = _table(b, b)
    ref = RK.segment_query_slab(*slab, table, OBJ8[:nf])
    port = K.segment_query_slab(*_t(*slab), torch.from_numpy(table),
                                OBJ8[:nf])
    assert tuple(port.shape) == (nf, b)
    np.testing.assert_allclose(to_np(port), np.asarray(ref), rtol=EST_RTOL,
                               atol=1e-6)


def test_segment_query_slab_rejects_bad_table():
    with pytest.raises(ValueError):
        K.segment_query_slab(*_t(*_slab(10, 0)),
                             torch.zeros((2, 5), dtype=torch.int32), OBJ8[:1])
