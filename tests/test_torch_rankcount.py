"""Parity of K6 (``repro_torch.kernels.rank_counts``) and of the kernel
compositions in ``repro_torch.kernels.ops`` / ``ref`` with the JAX
package's. On the CPU the wrapper runs K6's plain version; the reference
runs its Pallas kernel in interpret mode, as its own tests do (mirrors
tests/test_kernels.py and tests/test_batched_multiobj.py). Counts are
integers: exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402
import repro.core as C                                        # noqa: E402
import repro.kernels as RK                                    # noqa: E402
import repro_torch.core as T                                  # noqa: E402
import repro_torch.kernels as K                               # noqa: E402
from repro.kernels import ref as RR                           # noqa: E402
from repro_torch.kernels import rankcount as krc              # noqa: E402
from repro_torch.kernels import ref as TR                     # noqa: E402
from tests.torch_parity import (PROB_ULP, SEED_ULP,            # noqa: E402
                                assert_ulp, rw_gap_ok, to_np)

OBJS = ((0, 0.0), (3, 2.0), (1, 0.0))


def _operands(n, sigma=1.0, seed=0, inactive=0.07):
    """The operands ``ops.universal_capping_kernel`` hands K6 (ppswor,
    hash seed 0), as numpy arrays fed to both sides."""
    rng = np.random.default_rng(seed)
    w = rng.lognormal(0, sigma, n).astype(np.float32)
    act = rng.random(n) >= inactive
    u = C.uniform01(np.arange(n, dtype=np.int32), 0)
    rw = jnp.where(act, C.rank_of(u, "ppswor")
                   / jnp.maximum(jnp.asarray(w), 1e-30), jnp.inf)
    return (np.where(act, w, 0).astype(np.float32), np.array(u),
            np.array(rw), act)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_counts(ref, port):
    for name, r, p in zip(("h", "l"), ref, port):
        np.testing.assert_array_equal(np.asarray(r), to_np(p), err_msg=name)
        assert p.dtype == torch.int32


@pytest.mark.parametrize("n", [512, 700, 4096])
@pytest.mark.parametrize("sigma", [0.5, 2.5])
def test_rank_counts_matches_pallas(n, sigma):
    ops_ = _operands(n, sigma, seed=n)
    _assert_counts(RK.rank_counts(*ops_), K.rank_counts(*_t(*ops_)))


@pytest.mark.parametrize("case", ["ties", "all_inactive", "n1", "nan_w"])
def test_rank_counts_edge_inputs(case):
    """Tied weights and tied seeds (the strict < never counts a tie or the
    diagonal), all-inactive input, a single key, and NaN weights on active
    keys (no comparison holds): the reference's oracle, exactly."""
    rng = np.random.default_rng(1)
    n = 1 if case == "n1" else 600
    w = rng.choice(np.array([0.5, 1.0, 2.0], np.float32), n)
    sh = rng.choice(np.array([0.1, 0.2, 0.3], np.float32), n)
    sl = rng.choice(np.array([1.0, 3.0], np.float32), n)
    act = rng.random(n) < (0.0 if case == "all_inactive" else 0.9)
    if case == "nan_w":
        w[::7] = np.nan
    got = K.rank_counts(*_t(w, sh, sl, act))
    _assert_counts(RR.rank_counts_ref(w, sh, sl, act), got)
    _assert_counts(RR.rank_counts_ref(w, sh, sl, act),
                   TR.rank_counts_ref(*_t(w, sh, sl, act)))
    if case == "all_inactive":
        assert int(got[0].abs().sum() + got[1].abs().sum()) == 0


def test_rank_counts_plain_chunks_and_rows(monkeypatch):
    """The plain version's x-row chunking and its ``rows`` subset give the
    same counts as one unchunked pass."""
    ops_ = _t(*_operands(1500, seed=3))
    whole = krc.rank_counts_plain(*ops_)
    monkeypatch.setattr(krc, "PLAIN_PAIRS", 1500 * 7)   # 7 rows a chunk
    chunked = krc.rank_counts_plain(*ops_)
    rows = torch.tensor([0, 3, 1499, 700, 3])
    part = krc.rank_counts_plain(*ops_, rows=rows)
    for a, b, c in zip(whole, chunked, part):
        assert torch.equal(a, b)
        assert torch.equal(a[rows], c)


def _tie_operands(case):
    """Tie-heavy K6 inputs for the order reduction: weights from 4 values,
    u repeated (quantised to 2^6 values), all-equal weights, all keys
    inactive, a single key, and ragged n = 1500 with NaN weights and
    signed zeros."""
    rng = np.random.default_rng(len(case))
    n = {"n1": 1, "n1500": 1500}.get(case, 700)
    w = rng.lognormal(0, 1, n).astype(np.float32)
    sh = rng.random(n).astype(np.float32)
    sl = rng.exponential(1.0, n).astype(np.float32)
    act = rng.random(n) < 0.9
    if case == "four_weights":
        w = rng.choice(np.array([0.1, 1.0, 2.5, 10.0], np.float32), n)
        sl = (rng.integers(0, 16, n) / 4.0).astype(np.float32)
    elif case == "repeated_u":
        sh = (rng.integers(0, 64, n) / 64.0).astype(np.float32)
    elif case == "equal_weights":
        w[:] = 1.0
        sl = (rng.integers(0, 16, n) / 4.0).astype(np.float32)
    elif case == "all_inactive":
        act[:] = False
    elif case == "n1500":
        w = rng.choice(np.array([0.1, 1.0, 10.0], np.float32), n)
        w[::13] = -0.0
        sl[::5] = -0.0
        sl[1::5] = 0.0
    return np.where(act, w, 0).astype(np.float32), sh, sl, act


@pytest.mark.parametrize("case", ["four_weights", "repeated_u",
                                  "equal_weights", "all_inactive", "n1",
                                  "n1500"])
def test_order_reduction_matches_reference(case):
    """K6's counts as the card computes them, the order reduction
    ``rank_counts_by_order``, with its plain counting core (strict-<
    counts over each ordered sequence) in place of the kernel: equal to
    the reference's Pallas kernel (interpret mode) and to the plain
    all-pairs version, exactly."""
    ops_ = _tie_operands(case)
    got = krc.rank_counts_by_order(*_t(*ops_), krc.earlier_smaller_plain)
    _assert_counts(RK.rank_counts(*ops_), got)
    _assert_counts(krc.rank_counts_plain(*_t(*ops_)), got)


@pytest.mark.parametrize("case", ["ties", "nan_w", "nan_s"])
def test_order_reduction_edge_inputs(case):
    """NaN weights or seeds on active keys (no comparison with a NaN
    holds: such a key neither counts nor is counted), +inf seeds and
    tied triples: the reference's oracle, exactly."""
    rng = np.random.default_rng(7)
    n = 600
    w = rng.choice(np.array([0.5, 1.0, 2.0], np.float32), n)
    sh = rng.choice(np.array([0.1, 0.2, 0.3, np.inf], np.float32), n)
    sl = rng.choice(np.array([1.0, 3.0, np.inf], np.float32), n)
    act = rng.random(n) < 0.9
    if case == "nan_w":
        w[::7] = np.nan
    elif case == "nan_s":
        sh[::5] = np.nan
        sl[::3] = np.nan
    got = krc.rank_counts_by_order(*_t(w, sh, sl, act),
                                   krc.earlier_smaller_plain)
    _assert_counts(RR.rank_counts_ref(w, sh, sl, act), got)


def test_order_bits_follow_the_float_order():
    """The order reduction's float -> int64 map is monotone and ties -0.0
    with +0.0; the plain core's chunking gives the unchunked counts."""
    x = torch.tensor([-np.inf, -3.0, -1e-45, -0.0, 0.0, 1e-45, 1e-38, 0.5,
                      1.0, 3e38, np.inf], dtype=torch.float32)
    b = krc._order_bits(x)
    assert torch.all(b[1:] >= b[:-1])
    assert int(b[3]) == int(b[4])
    assert int((b[1:] > b[:-1]).sum()) == x.numel() - 2
    assert int(b.min()) >= 0 and int(b.max()) < 1 << 32
    s = torch.from_numpy(np.random.default_rng(2).integers(
        0, 9, (2, 300)).astype(np.float32))
    pos = torch.stack([torch.randperm(300), torch.randperm(300)]).int()
    assert torch.equal(krc.earlier_smaller_plain(s, pos, step=7),
                       krc.earlier_smaller_plain(s, pos))


def test_rank_counts_cpu_path_is_not_counted():
    K.reset_launch_counts()
    K.rank_counts(*_t(*_operands(300)))
    assert K.launch_counts()["rankcount"] == 0
    assert K.COUNTED["rankcount"] is K.rank_counts


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
def test_capping_kernel_matches(scheme):
    """ops.universal_capping_kernel against the reference's (member and hl
    exact) and against the core capping oracle, hl on active keys only.
    Under ppswor each side computes its own r / w, which differ by up to
    SEED_ULP; exactness needs no two active keys' r / w within that
    window (asserted)."""
    n, k = 2048, 16
    rng = np.random.default_rng(0)
    keys = np.arange(n, dtype=np.int32)
    w = rng.lognormal(0, 1.5, n).astype(np.float32)
    act = rng.random(n) > 0.05
    if scheme == "ppswor":
        assert rw_gap_ok(np.asarray(C.ppswor_rank(C.uniform01(keys, 0))),
                         w, act & (w > 0))
    m_ref, hl_ref = RK.ops.universal_capping_kernel(
        jnp.asarray(keys), jnp.asarray(w), jnp.asarray(act), k, scheme)
    m_p, hl_p = K.ops.universal_capping_kernel(keys, w, act, k, scheme,
                                               device="cpu")
    np.testing.assert_array_equal(np.asarray(m_ref), to_np(m_p))
    np.testing.assert_array_equal(np.asarray(hl_ref), to_np(hl_p))
    u = to_np(T.uniform01(keys, 0))
    core = T.universal_capping_ref(w, u, act, k, scheme, device="cpu")
    assert torch.equal(m_p, core.member)
    assert torch.equal(hl_p[torch.from_numpy(act)],
                       core.hl[torch.from_numpy(act)])


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("n,k", [(4096, 16), (1500, 64), (100, 200)])
def test_multi_objective_kernel_matches(scheme, n, k):
    """ops.multi_objective_bottomk_kernel (K1 + K2) against the
    reference's and against the port's core multi-objective sampler."""
    rng = np.random.default_rng(n)
    keys = np.arange(n, dtype=np.int32)
    w = rng.lognormal(0, 1.5, n).astype(np.float32)
    act = rng.random(n) > 0.05
    m_ref, p_ref = RK.ops.multi_objective_bottomk_kernel(
        jnp.asarray(keys), jnp.asarray(w), jnp.asarray(act), OBJS, k,
        scheme=scheme)
    m_p, p_p = K.ops.multi_objective_bottomk_kernel(keys, w, act, OBJS, k,
                                                    scheme=scheme,
                                                    device="cpu")
    np.testing.assert_array_equal(np.asarray(m_ref), to_np(m_p))
    assert_ulp(p_ref, p_p, PROB_ULP, "prob")
    core = T.multi_bottomk_sample(keys, w, act,
                                  [(K.ops.statfn_of(*o), k) for o in OBJS],
                                  scheme=scheme, device="cpu")
    assert torch.equal(m_p, core.member)
    assert float((p_p - core.prob).abs().max()) <= 1e-6


def test_ops_reject_bogus_scheme_and_statfn_of():
    keys = np.arange(8, dtype=np.int32)
    w = np.ones(8, np.float32)
    act = np.ones(8, bool)
    with pytest.raises(ValueError, match="scheme"):
        K.ops.multi_objective_bottomk_kernel(keys, w, act, OBJS, 4,
                                             scheme="bogus", device="cpu")
    with pytest.raises(ValueError, match="scheme"):
        K.ops.universal_capping_kernel(keys, w, act, 4, scheme="bogus",
                                       device="cpu")
    for kind, param in ((0, 0.0), (1, 0.0), (2, 5.0), (3, 2.0), (4, 1.5)):
        f = K.ops.statfn_of(kind, param)
        assert f.name == RK.ops.statfn_of(kind, param).name


@pytest.mark.parametrize("n,k", [(2048, 16), (4096, 64), (3000, 33)])
def test_ref_oracles_match(n, k):
    """The port's kernels/ref.py oracles against the reference's."""
    rng = np.random.default_rng(k)
    seeds = rng.exponential(1.0, n).astype(np.float32)
    seeds[rng.random(n) > 0.9] = np.inf
    seeds[5:40:4] = seeds[3]                      # ties
    b = min(2048, n) if n % 2048 == 0 else n
    for ref, port in zip(RR.block_bottomk_ref(seeds, k, b),
                         TR.block_bottomk_ref(torch.from_numpy(seeds), k, b)):
        np.testing.assert_array_equal(np.asarray(ref), to_np(port))
    for ref, port in zip(RR.bottomk_select_ref(seeds, k),
                         TR.bottomk_select_ref(torch.from_numpy(seeds), k)):
        np.testing.assert_array_equal(np.asarray(ref), to_np(port))
    s2 = np.stack([seeds, seeds[::-1].copy()])
    for ref, port in zip(RR.batched_bottomk_select_ref(s2, k),
                         TR.batched_bottomk_select_ref(torch.from_numpy(s2),
                                                       k)):
        np.testing.assert_array_equal(np.asarray(ref), to_np(port))
    keys = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
    w = rng.lognormal(0, 1.5, n).astype(np.float32)
    act = rng.random(n) > 0.1
    assert_ulp(RR.fused_seeds_ref(keys, w, act, OBJS, "ppswor", 5),
               TR.fused_seeds_ref(*_t(keys, w, act), OBJS, "ppswor", 5),
               SEED_ULP, "fused_seeds_ref")
