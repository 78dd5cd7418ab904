"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the card. Imports neither JAX nor the reference, so it runs on
a machine with a CUDA build of PyTorch and nvcc alone (it imports no other
test module either: a site-packages ``tests`` package may shadow ours):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test carries the ``gpu`` marker and skips where there is no card.
Tolerances: one libm on both sides, so seeds and f-values within 2 ulp
(measured 0), selections, priorities and K6's rank counts exact, the
universal samples and sketch folds on the card bit-equal to the same calls
on the CPU (capping under ppswor where no two active r/w lie within 8 ulp:
the CPU's log1p may round r differently), estimates rtol 1e-5; K5's
ball-mode estimates within that rtol plus the HT weight of the slots whose
d2 lies within 8 eps32 (|x|^2 + |c|^2) of r^2 (the two sides sum the dot
products in another order); on a one-slot slab, where no sum averages a
slot's rounding, each K5 row within that rtol plus the HT weight times
the spread of the slot's value over d2 +- 8 eps32 (|x|^2 + |c|^2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.kernels as K                               # noqa: E402
from repro_torch.kernels import attention as KA              # noqa: E402
from repro_torch.kernels import blockselect as kbs            # noqa: E402
from repro_torch.kernels import compact as kc                 # noqa: E402
from repro_torch.kernels import seeds as ks                   # noqa: E402
from repro_torch.kernels import segquery as kq                # noqa: E402
from repro_torch.kernels import servicecost as ksc            # noqa: E402
from repro_torch.kernels import rankcount as krc              # noqa: E402
import repro_torch.core as T                                  # noqa: E402
from repro_torch.core import costs as CO                      # noqa: E402
from repro_torch.core import predicates as P                  # noqa: E402

pytestmark = pytest.mark.gpu
EST_RTOL = 1e-5
K4_CHUNK = 1152         # slots segquery.cu stages per pass (Q_CHUNK)

# kind 0=sum, 1=count, 2=thresh, 3=cap, 4=moment (kernels/seeds.py)
OBJ8 = ((0, 0.0), (1, 0.0), (2, 2.0), (3, 1.5), (4, 1.5), (2, 0.5),
        (3, 4.0), (4, 0.5))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def assert_ulp(a, b, bound: int, what: str):
    assert torch.equal(torch.isinf(a), torch.isinf(b)), what
    fin = torch.isfinite(a)
    d = (a[fin].view(torch.int32).to(torch.int64)
         - b[fin].view(torch.int32).to(torch.int64)).abs()
    assert int(d.max().item() if d.numel() else 0) <= bound, what


def _plain_attention(patch):
    """Attention's plain loop on every device, for an fp32 model on the
    card (the attention kernel takes bf16 alone)."""
    patch.setattr(KA, "attention_forward", KA.attention_forward_plain)
    patch.setattr(KA, "attention_backward", KA.attention_backward_plain)


def _on(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
def test_seeds_kernel_matches_plain(cuda, scheme):
    rng = np.random.default_rng(1)
    n = 5000
    keys, w, act = _on(cuda, rng.integers(0, 2 ** 31 - 1, n).astype(np.int32),
                       rng.lognormal(0, 1.5, n).astype(np.float32),
                       rng.random(n) < 0.9)
    s, f = K.fused_seeds_fvals(keys, w, act, OBJ8, scheme, 3)
    sp, fp = ks.fused_seeds_fvals_plain(keys, w, act, OBJ8, scheme, 3)
    assert_ulp(s, sp, 2, "seeds")
    assert_ulp(f, fp, 2, "fvals")


def _assert_k1_close(objs, s, f, sp, fp):
    """K1 against its plain version: sum/count/thresh/cap f-values bit for
    bit, moment f-values and seeds within 2 ulp."""
    assert_ulp(s, sp, 2, "seeds")
    if f is None:
        return
    for j, (kind, _) in enumerate(objs):
        if kind == 4:
            assert_ulp(f[j], fp[j], 2, f"fvals[{j}]")
        else:
            assert torch.equal(f[j], fp[j]), f"fvals[{j}]"


@pytest.mark.parametrize("want_fvals", [True, False],
                         ids=["fvals", "seeds_only"])
@pytest.mark.parametrize("nf", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 3, 5, 127, 129, 1023, 1025, 4097, 16_402,
                               1_056_777])
def test_seeds_kernel_rows_heads_and_tails(cuda, n, nf, want_fvals):
    """Odd n (and n = 2 mod 4) put row j of the [F, n] outputs at every
    16-byte offset, so each row's shifted head, aligned body and scalar
    tail are written; the last partial quad and the last partial tile are
    hit too."""
    rng = np.random.default_rng(n + nf)
    keys, w, act = _on(cuda, rng.integers(0, 2 ** 31 - 1, n).astype(np.int32),
                       rng.lognormal(0, 1.5, n).astype(np.float32),
                       rng.random(n) < 0.9)
    w[::7] = 0.0
    objs = OBJ8[:nf]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    s, f = ks.seeds_and_fvals(keys, w, act, objs, "ppswor", 3,
                              want_fvals=want_fvals)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    sp, fp = ks.fused_seeds_fvals_plain(keys, w, act, objs, "ppswor", 3)
    _assert_k1_close(objs, s, f, sp, fp)
    if not want_fvals:
        assert f is None
        # the seeds alone: one [F, n] float32 array (allocator-rounded)
        assert grown <= ((nf * n * 4 + 511) // 512) * 512 + 512
    assert torch.equal(K.fused_seeds(keys, w, act, objs, "ppswor", 3), s)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_seeds_kernel_on_unaligned_input_views(cuda, offset):
    """Inputs that start off a 16-byte boundary (views into a larger
    buffer) take the kernel's scalar loads."""
    rng = np.random.default_rng(offset)
    n = 5003
    keys, w, act = _on(cuda, rng.integers(0, 2 ** 31 - 1, n).astype(np.int32),
                       rng.lognormal(0, 1.5, n).astype(np.float32),
                       rng.random(n) < 0.9)
    kv, wv, av = keys[offset:], w[offset:], act[offset:]
    assert kv.data_ptr() % 16 != 0
    s, f = K.fused_seeds_fvals(kv, wv, av, OBJ8, "priority", 5)
    sp, fp = ks.fused_seeds_fvals_plain(kv, wv, av, OBJ8, "priority", 5)
    _assert_k1_close(OBJ8, s, f, sp, fp)


@pytest.mark.parametrize("n,k", [(5000, 5), (5000, 1025), (5000, 2049),
                                 (100, 64)])
def test_blockselect_kernel_matches_plain(cuda, n, k):
    s = torch.rand((3, n), device=cuda)
    s[:, ::5] = float("inf")
    s[:, 7:300:3] = 0.5                         # ties
    got = kbs.block_candidates(s, k)
    want = kbs.block_candidates_plain(s, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(K.batched_bottomk_select(s, k),
                    kbs.batched_bottomk_select_plain(s, k)):
        assert torch.equal(a, b)


def _select_rows(kind, nf, n, k, rng):
    """[nf, n] seeds of one adversarial kind for K2's global route."""
    s = rng.uniform(0.5, 1.0, (nf, n)).astype(np.float32)
    if kind == "all_inf":
        s[:] = np.inf
    elif kind == "few_finite":                # fewer than k finite seeds
        s[:, max(k - 1, 0) // 2:] = np.inf
        s = rng.permuted(s, axis=1)
    elif kind == "all_equal":
        s[:] = 0.75
    elif kind == "ties_at_threshold":         # the (k+1)-th is a tie
        for r in range(nf):                   # spread over every span
            pos = rng.choice(n, size=min(n, 2 * (k + 1)), replace=False)
            s[r, pos] = 0.25
            s[r, pos[:(k + 1) // 2]] = 0.125
    elif kind == "signed_zeros":              # -0.0 ties with +0.0
        s[:, ::2] = -0.0
        s[:, 1::4] = 0.0
    return s


SELECT_KINDS = ("all_inf", "few_finite", "all_equal", "ties_at_threshold",
                "signed_zeros")


@pytest.mark.parametrize("k", [1, 5, 1025, 2049, 8202])
@pytest.mark.parametrize("n", [1, 100, 2049, 5000, 1_056_777])
@pytest.mark.parametrize("nf", [1, 8])
def test_global_select_matches_plain_bit_for_bit(cuda, nf, n, k):
    """K2's global route (``batched_bottomk_select`` on the card) against
    its plain version: vals (as bits), idx and tau equal, one launch per
    call, on every adversarial kind of row, n <= k and n = k + 1
    included."""
    rng = np.random.default_rng(n + k + nf)
    for kind in SELECT_KINDS + ("random",):
        s = torch.from_numpy(_select_rows(kind, nf, n, k, rng)).to(cuda)
        before = K.launch_counts()["blockselect"]
        got = K.batched_bottomk_select(s, k)
        assert K.launch_counts()["blockselect"] == before + 1
        want = kbs.batched_bottomk_select_plain(s, k)
        for a, b, name in zip(got, want, ("vals", "idx", "tau")):
            assert a.shape == b.shape, (kind, name)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (kind, name)


@pytest.mark.parametrize("k", [1, 1025, 2049])
def test_global_select_at_n_equal_k_plus_one(cuda, k):
    rng = np.random.default_rng(k)
    for kind in SELECT_KINDS + ("random",):
        s = torch.from_numpy(_select_rows(kind, 8, k + 1, k, rng)).to(cuda)
        for a, b in zip(K.batched_bottomk_select(s, k),
                        kbs.batched_bottomk_select_plain(s, k)):
            assert torch.equal(a, b), kind


@pytest.mark.parametrize("n,k", [(20_000, 16_383), (100_000, 16_384),
                                 (1_056_777, 20_000)])
def test_global_select_past_the_rank_sort(cuda, n, k):
    """Up to RANK_Q_MAX = 16,384 candidates the kernel sorts them by rank;
    past it torch.sort does: both equal to the plain version."""
    rng = np.random.default_rng(k)
    for kind in ("ties_at_threshold", "signed_zeros", "random"):
        s = torch.from_numpy(_select_rows(kind, 2, n, k, rng)).to(cuda)
        for a, b in zip(K.batched_bottomk_select(s, k),
                        kbs.batched_bottomk_select_plain(s, k)):
            assert torch.equal(a, b), kind


def test_compact_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    n = 5000
    member = rng.random(n) < 0.2
    ins = _on(cuda, np.sort(rng.integers(-3, n // 2, n)).astype(np.int32),
              rng.lognormal(0, 1, n).astype(np.float32), member,
              member | (rng.random(n) < 0.05))
    assert torch.equal(K.retention_priority(*ins),
                       kc.retention_priority_plain(*ins))
    got, want = K.compact_take(*ins, 300), kc.compact_take_plain(*ins, 300)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_segquery_kernel_matches_plain_and_is_batch_independent(cuda):
    rng = np.random.default_rng(4)
    c = 3000
    keys = rng.integers(0, 40_000, c).astype(np.int32)
    keys[rng.random(c) < 0.1] = -1
    slab = _on(cuda, keys, rng.lognormal(0, 1.5, c).astype(np.float32),
               rng.uniform(0.02, 1.0, c).astype(np.float32),
               (rng.random(c) < 0.8) & (keys >= 0))
    preds = [P.EVERYTHING]
    for i in range(127):
        lo = int(rng.integers(0, 30_000))
        preds.append([P.key_range(lo, lo + 9_000), P.key_mask(7, i % 8),
                      P.hash_fraction(0.37, i)][i % 3])
    table = _on(cuda, P.encode_predicates(preds))[0]
    got = K.segment_query_slab(*slab, table, OBJ8)
    want = kq.segment_query_slab_plain(*slab, table, OBJ8)
    torch.testing.assert_close(got, want, rtol=EST_RTOL, atol=1e-6)
    assert torch.equal(got, K.segment_query_slab(*slab, table, OBJ8))
    for i in (0, 5, 77):
        alone = K.segment_query_slab(*slab, table[i:i + 1].contiguous(),
                                     OBJ8)
        assert torch.equal(alone[:, 0], got[:, i])


def _k4_slab(dev, c, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40_000, c).astype(np.int32)
    keys[rng.random(c) < 0.1] = -1
    return _on(dev, keys, rng.lognormal(0, 1.5, c).astype(np.float32),
               rng.uniform(0.02, 1.0, c).astype(np.float32),
               (rng.random(c) < 0.8) & (keys >= 0))


def _k4_table(dev, b, seed):
    rng = np.random.default_rng(seed)
    preds = [P.EVERYTHING]
    for i in range(b - 1):
        lo = int(rng.integers(0, 30_000))
        preds.append([P.key_range(lo, lo + 9_000), P.key_mask(7, i % 8),
                      P.hash_fraction(0.37, i)][i % 3])
    return _on(dev, P.encode_predicates(preds))[0]


@pytest.mark.parametrize("b", [1, 7, kq.TILE_B, kq.TILE_B + 1, 256, 1000])
@pytest.mark.parametrize("c", [1, kq.SLICE_TARGET - 1, kq.SLICE_TARGET,
                               kq.SLICE_TARGET + 1, 8201,
                               kq.MAX_SLICES * K4_CHUNK + 1])
def test_segquery_split_slab_matches_plain_with_fixed_bits(cuda, c, b):
    """The slab split across blocks: plain-version parity, one launch per
    call, run-to-run bits, and each column alone equal to its bits in the
    batch (the last c takes two staging passes a slice)."""
    slab = _k4_slab(cuda, c, c)
    table = _k4_table(cuda, b, b)
    before = K.launch_counts()["segquery"]
    got = K.segment_query_slab(*slab, table, OBJ8)
    assert K.launch_counts()["segquery"] == before + 1
    want = kq.segment_query_slab_plain(*slab, table, OBJ8)
    torch.testing.assert_close(got, want, rtol=EST_RTOL, atol=1e-6)
    assert torch.equal(got, K.segment_query_slab(*slab, table, OBJ8))
    for i in sorted({0, b // 2, b - 1}):
        alone = K.segment_query_slab(*slab, table[i:i + 1].contiguous(),
                                     OBJ8)
        assert torch.equal(alone[:, 0], got[:, i]), i


def test_empty_slab_answers_zeros(cuda):
    """c = 0: both kernels launch and answer exact zeros."""
    slab = _k4_slab(cuda, 0, 0)
    table = _k4_table(cuda, 17, 1)
    assert torch.equal(K.segment_query_slab(*slab, table, OBJ8),
                       torch.zeros((8, 17), device=cuda))
    _, ctable = _k5_inputs(cuda, 7, 20, 68, c=1)
    pts = torch.empty((0, 68), device=cuda)
    probs = torch.empty((0,), device=cuda)
    member = torch.empty((0,), dtype=torch.bool, device=cuda)
    before = K.launch_counts()["servicecost"]
    got = K.service_cost_slab(pts, probs, member, ctable)
    assert K.launch_counts()["servicecost"] == before + 1
    assert torch.equal(got, torch.zeros(7, device=cuda))


def _k5_inputs(dev, q, cmax, dim, c=4098, seed=6, mode="mix"):
    """A slab of c points and a [q, cmax] table: ragged sets near the data,
    one all-invalid row, mu cycling 1, 2, 1.5 and every 4th row in ball
    mode (``mode="mix"``), or one mode for every row."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 6, (c, dim)).astype(np.float32)
    centers = (pts[rng.integers(0, c, (q, cmax))]
               + rng.normal(0, 0.5, (q, cmax, dim))).astype(np.float32)
    cvalid = np.arange(cmax)[None, :] < rng.integers(1, cmax + 1, (q, 1))
    if q > 5:
        cvalid[5] = False
    mu = np.array([1.0, 2.0, 1.5], np.float32)[np.arange(q) % 3]
    ball = (np.arange(q) % 4 == 3) if mode == "mix" else np.full(
        q, mode == "ball")
    radius = np.sqrt(np.float32(dim)) * rng.uniform(2, 10, q).astype(
        np.float32)
    slab = _on(dev, pts, rng.uniform(0.02, 1.0, c).astype(np.float32),
               rng.random(c) < 0.8)
    table = CO.table_to(CO.CostTable(centers, cvalid, mu, radius,
                                     ball.astype(np.int32)), dev)
    return slab, table


def _assert_k5_close(got, want, slab, table):
    """Cost rows within rtol 1e-5; ball rows within it plus the HT weight
    of the slots near r^2 under the plain d2."""
    pts, probs, member = slab
    ht = torch.where(member, 1.0 / torch.clamp_min(probs, 1e-30),
                     torch.zeros_like(probs)).double()
    pn2 = (pts.double() ** 2).sum(1)
    for i in range(got.shape[0]):
        slack = EST_RTOL * abs(float(want[i])) + 1e-6
        if int(table.mode[i]) == CO.MODE_BALL and bool(table.cvalid[i].any()):
            ctr = table.centers[i][table.cvalid[i]]
            d2 = CO.sq_dists(ctr, pts).double()
            tol = 8 * 2.0 ** -23 * ((ctr.double() ** 2).sum(1)[:, None]
                                    + pn2[None, :])
            near = ((d2.min(0).values - float(table.param[i]) ** 2).abs()
                    <= tol.max(0).values)
            slack += float(ht[near].sum())
        assert abs(float(got[i]) - float(want[i])) <= slack, (i, got[i],
                                                              want[i])


@pytest.mark.parametrize("q,cmax,dim,mode", [
    (1, 20, 68, "cost"), (128, 20, 68, "mix"), (128, 1, 68, "mix"),
    (128, 20, 68, "ball"), (64, 7, 3, "mix")])
def test_servicecost_kernel_matches_plain(cuda, q, cmax, dim, mode):
    slab, table = _k5_inputs(cuda, q, cmax, dim, mode=mode)
    got = K.service_cost_slab(*slab, table)
    want = ksc.service_cost_slab_plain(*slab, table)
    _assert_k5_close(got, want, slab, table)
    if q > 5:
        assert float(got[5]) == 0.0                 # all-invalid row
    pw = torch.rand(slab[0].shape[0], device=cuda)
    _assert_k5_close(K.service_cost_slab(*slab, table, point_weights=pw),
                     ksc.service_cost_slab_plain(*slab, table, pw), slab,
                     table)


def test_servicecost_kernel_is_deterministic_and_batch_independent(cuda):
    slab, table = _k5_inputs(cuda, 128, 20, 68)
    full = K.service_cost_slab(*slab, table)
    assert torch.equal(full, K.service_cost_slab(*slab, table))
    for i in (0, 3, 77, 127):
        alone = CO.CostTable(*(x[i:i + 1].contiguous() for x in table))
        assert torch.equal(K.service_cost_slab(*slab, alone)[0], full[i])
    # a set padded to a larger Cmax keeps its bits
    wide = CO.CostTable(
        torch.nn.functional.pad(table.centers, (0, 0, 0, 12)),
        torch.nn.functional.pad(table.cvalid, (0, 12)), *table[2:])
    assert torch.equal(K.service_cost_slab(*slab, wide), full)
    null = CO.table_to(CO.pad_cost_table(CO.CostTable(
        *(x[:3].cpu().numpy() for x in table)), 16), cuda)
    got = K.service_cost_slab(*slab, null)
    assert torch.equal(got[:3], full[:3])
    assert torch.equal(got[3:], torch.zeros(13, device=cuda))


def _assert_k5_slot_close(got, want, slab, table):
    """For a slab of a few slots, where no sum averages a slot's d2
    rounding away: every row within rtol 1e-5 plus, per slot, the HT
    weight times the spread of its value over the plain d2 +- 8 eps32
    (|x|^2 + |c|^2) (both sides expand d2 = (|c|^2 + |x|^2) - 2 x.c,
    rounded in another order; near a center that cancels)."""
    pts, probs, member = slab
    ht = torch.where(member, 1.0 / torch.clamp_min(probs, 1e-30),
                     torch.zeros_like(probs)).double()
    pn2 = (pts.double() ** 2).sum(1)
    for i in range(got.shape[0]):
        slack = EST_RTOL * abs(float(want[i])) + 1e-6
        if bool(table.cvalid[i].any()):
            ctr = table.centers[i][table.cvalid[i]]
            d2 = CO.sq_dists(ctr, pts).double().min(0).values
            tol = (8 * 2.0 ** -23 * ((ctr.double() ** 2).sum(1)[:, None]
                                     + pn2[None, :])).max(0).values
            if int(table.mode[i]) == CO.MODE_BALL:
                r2 = float(table.param[i]) ** 2
                slack += float(ht[(d2 - r2).abs() <= tol].sum())
            else:
                e = 0.5 * float(table.mu[i])
                lo = (d2 - tol).clamp_min(0.0) ** e
                slack += float((ht * ((d2 + tol) ** e - lo)).sum())
        assert abs(float(got[i]) - float(want[i])) <= slack, (i, got[i],
                                                              want[i])


def _largest_dim(cmax):
    return max(d for d in range(1, 641) if ksc.supported(d, cmax))


@pytest.mark.parametrize("c", [1, 4098])
@pytest.mark.parametrize("cmax", [1, 20, 64])
@pytest.mark.parametrize("dim", [3, 68, "largest"])
def test_servicecost_tiled_matches_plain_with_fixed_bits(cuda, c, cmax,
                                                         dim):
    """The tiled kernel at Q = 7 (not a multiple of the 4 sets a cluster
    scores), over Cmax and dim up to the largest dim the plan accepts:
    plain-version parity, the all-invalid row 0, run-to-run bits, each set
    alone equal to its bits in the batch, and Cmax padding keeping them.
    At c = 1 the rows are single slots: held per slot to the d2 window
    (``_assert_k5_slot_close``); at c = 4098 as the tests above."""
    dim = _largest_dim(cmax) if dim == "largest" else dim
    q = 7
    close = _assert_k5_slot_close if c == 1 else _assert_k5_close
    slab, table = _k5_inputs(cuda, q, cmax, dim, c=c, seed=c + cmax + dim)
    before = K.launch_counts()["servicecost"]
    full = K.service_cost_slab(*slab, table)
    assert K.launch_counts()["servicecost"] == before + 1
    close(full, ksc.service_cost_slab_plain(*slab, table), slab, table)
    assert float(full[5]) == 0.0                    # all-invalid row
    pw = torch.rand(slab[0].shape[0], device=cuda)
    close(K.service_cost_slab(*slab, table, point_weights=pw),
          ksc.service_cost_slab_plain(*slab, table, pw), slab, table)
    assert torch.equal(full, K.service_cost_slab(*slab, table))
    for i in range(q):
        alone = CO.CostTable(*(x[i:i + 1].contiguous() for x in table))
        assert torch.equal(K.service_cost_slab(*slab, alone)[0], full[i]), i
    pad = next((p for p in (12, 4, 1) if ksc.supported(dim, cmax + p)),
               None)
    if pad is not None:
        wide = CO.CostTable(
            torch.nn.functional.pad(table.centers, (0, 0, 0, pad)),
            torch.nn.functional.pad(table.cvalid, (0, pad)), *table[2:])
        assert torch.equal(K.service_cost_slab(*slab, wide), full)


# ----------------------------------------------------------------------- K6
def _k6_operands(dev, n, seed, inactive=0.1):
    rng = np.random.default_rng(seed)
    w = rng.choice(np.array([0.5, 1.0, 2.0, 3.5], np.float32), n)
    w[: n // 2] = rng.lognormal(0, 1, n // 2).astype(np.float32)   # + ties
    sh = rng.random(n).astype(np.float32)
    sh[::5] = 0.25                                                 # ties
    sl = rng.exponential(1.0, n).astype(np.float32)
    act = rng.random(n) >= inactive
    return _on(dev, np.where(act, w, 0).astype(np.float32), sh, sl, act)


@pytest.mark.parametrize("n,inactive", [(1, 0.0), (255, 0.1), (256, 0.1),
                                        (257, 0.1), (1000, 0.1),
                                        (5003, 0.1), (4096, 1.0)],
                         ids=["n1", "255", "256", "257", "1000", "5003",
                              "all_inactive"])
def test_rankcount_kernel_matches_plain(cuda, n, inactive):
    ops_ = _k6_operands(cuda, n, n, inactive)
    before = K.launch_counts()["rankcount"]
    h, l = K.rank_counts(*ops_)
    assert K.launch_counts()["rankcount"] == before + 1
    hp, lp = krc.rank_counts_plain(*ops_)
    assert torch.equal(h, hp) and torch.equal(l, lp)
    if inactive == 1.0:
        assert int(h.abs().sum() + l.abs().sum()) == 0


def _k6_tie_operands(dev, n, kind, seed):
    """Tie-heavy K6 inputs: weights from 4 values, u quantised to 2^10
    values, all-equal weights, or all keys inactive."""
    rng = np.random.default_rng(seed)
    w = rng.lognormal(0, 1, n).astype(np.float32)
    sh = (rng.integers(0, 1 << 10, n) / 1024.0).astype(np.float32)
    sl = rng.exponential(1.0, n).astype(np.float32)
    act = rng.random(n) >= 0.05
    if kind == "four_weights":
        w = rng.choice(np.array([0.1, 1.0, 2.5, 10.0], np.float32), n)
        sl = (rng.integers(0, 64, n) / 8.0).astype(np.float32)
    elif kind == "equal_weights":
        w[:] = 1.0
    elif kind == "all_inactive":
        act[:] = False
    return _on(dev, np.where(act, w, 0).astype(np.float32), sh, sl, act)


@pytest.mark.parametrize("kind", ["four_weights", "quantised_u",
                                  "equal_weights", "all_inactive"])
@pytest.mark.parametrize("n", [1, 1500, 2048, 2049, 4097, 65_536])
def test_rankcount_dominance_count_exact_on_ties(cuda, n, kind):
    """K6's O(n log n) count against the all-pairs plain version on every
    row of tie-heavy inputs, across the run (2048) and merge-level
    boundaries."""
    ops_ = _k6_tie_operands(cuda, n, kind, n)
    before = K.launch_counts()["rankcount"]
    h, l = K.rank_counts(*ops_)
    assert K.launch_counts()["rankcount"] == before + 1
    hp, lp = krc.rank_counts_plain(*ops_)
    assert torch.equal(h, hp) and torch.equal(l, lp)
    if kind == "all_inactive":
        assert int(h.abs().sum() + l.abs().sum()) == 0


def _rw_gap_ok(keys, w, act, seed) -> bool:
    """No two active keys' ppswor r/w within 8 ulp (the CPU's and the
    card's log1p may round r apart by an ulp or two)."""
    u = T.uniform01(torch.from_numpy(keys), seed)
    rw = (T.ppswor_rank(u) / torch.from_numpy(w))[torch.from_numpy(act)]
    iv = torch.sort(rw).values.view(torch.int32).to(torch.int64)
    return bool(torch.all(iv[1:] - iv[:-1] > 8))


def _universal_inputs(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(4 * n)[:n].astype(np.int32)
    w = np.clip(rng.lognormal(0, 1, n), 0.1, 10).astype(np.float32)
    w[::9] = 1.0                                                   # ties
    return keys, w, rng.random(n) > 0.05


@pytest.mark.parametrize("scheme,n", [("priority", 3000), ("ppswor", 600)])
def test_capping_on_card_equals_cpu(cuda, scheme, n):
    """ops.universal_capping_kernel (K6) and universal_capping_sample on
    the card against the same calls on the CPU. Under ppswor the r/w gap
    precondition holds at this n (asserted)."""
    keys, w, act = _universal_inputs(n, 1)
    if scheme == "ppswor":
        assert _rw_gap_ok(keys, w, act, 5)
    on_card = K.ops.universal_capping_kernel(keys, w, act, 32, scheme,
                                             seed=5, device=cuda)
    on_cpu = K.ops.universal_capping_kernel(keys, w, act, 32, scheme,
                                            seed=5, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    card = T.universal_capping_sample(keys, w, act, 32, m_cap=n,
                                      scheme=scheme, seed=5, device=cuda)
    cpu = T.universal_capping_sample(keys, w, act, 32, m_cap=n,
                                     scheme=scheme, seed=5, device="cpu")
    for name in ("member", "aux", "hl"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
    assert torch.equal(card.member, on_card[0])
    if scheme == "priority":
        assert torch.equal(card.prob.cpu(), cpu.prob)
    else:
        assert_ulp(card.prob.cpu(), cpu.prob, 4, "capping prob")


def test_universal_monotone_and_merge_fold_on_card_equal_cpu(cuda):
    """The universal monotone sample and a build_sketch + merge_sketches
    fold over 8 shards, bit for bit on the card and on the CPU."""
    keys, w, act = _universal_inputs(20_000, 2)
    w = np.random.default_rng(3).lognormal(0, 2, 20_000).astype(np.float32)
    for name, a, b in zip(
            T.UniversalSample._fields,
            T.universal_monotone_sample(keys, w, act, 64, seed=42,
                                        device=cuda),
            T.universal_monotone_sample(keys, w, act, 64, seed=42,
                                        device="cpu")):
        assert torch.equal(a.cpu(), b), name
    cap = T.sketch_capacity(20_000, 64)
    folds = {}
    for dev in (cuda, torch.device("cpu")):
        merged = None
        for p in np.array_split(np.arange(20_000), 8):
            sk = T.build_sketch(keys[p], w[p], act[p], 64, cap, seed=42,
                                device=dev)
            merged = sk if merged is None else T.merge_sketches(
                merged, sk, donate=dev.type == "cuda")
        folds[dev.type] = merged
    for name in ("keys", "weights", "probs", "member", "valid"):
        assert torch.equal(getattr(folds["cuda"], name).cpu(),
                           getattr(folds["cpu"], name)), name


# ---------------------------------------------------------- training path
def test_gradient_exchange_kernel_matches_plain(cuda):
    """``_sample_leaf`` through K1 (seeds only) + K2 against their plain
    versions on a 3,000,000-row leaf with ties and zeros: keys, valid,
    member and weights exact, seeds and taus within 2 ulp, probs within 4
    ulp; and at one pod the exchange returns its input."""
    from repro_torch.distopt import compression as CP
    from repro_torch.launch.mesh import Mesh
    rng = np.random.default_rng(7)
    g = rng.standard_normal(3_000_000).astype(np.float32)
    ties = rng.random(g.size) < 0.3
    g[ties] = np.round(g[ties], 1)
    g[rng.random(g.size) < 0.1] = 0.0
    tg = torch.from_numpy(g).to(cuda)
    before = K.launch_counts()
    a = CP._sample_leaf(tg, 256, 4_000_000_123, 0.01)
    after = K.launch_counts()
    assert after["seeds"] - before["seeds"] == 1
    assert after["blockselect"] - before["blockselect"] == 1
    b = CP._sample_leaf(tg, 256, 4_000_000_123, 0.01, use_kernels=False)
    for name in ("keys", "valid", "member", "aux", "weights"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert_ulp(a.seeds, b.seeds, 2, "seeds")
    assert_ulp(a.taus, b.taus, 2, "taus")
    assert_ulp(a.probs, b.probs, 4, "probs")
    assert 0 < int(a.valid.sum()) <= 768
    mesh = Mesh((1, 1, 1), ("pod", "data", "model"), device=cuda)
    out = CP.exchange_grads(mesh, {"g": tg.reshape(3000, 1000)}, 2, k=256)
    assert torch.equal(out["g"].reshape(-1), tg)


def test_full_width_train_step(cuda):
    """One train step of qwen2-1.5b at full width (28 layers, d_model
    1536, vocab 151,936) with the sampled exchange at one pod and the
    telemetry fold: a finite loss near ln(vocab) x the init scale, the
    step counted, launches (9, 10, 1, 0, 0, 0)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import multisketch_empty
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TEL_SPEC
    from repro_torch.models.model import init_model
    from repro_torch.optim import adamw
    cfg = get_config("qwen2-1.5b")
    mesh = Mesh((1, 1, 1), ("pod", "data", "model"), device=cuda)
    step, _ = make_train_step(cfg, adamw.OptConfig(), mesh,
                              compress=dict(k=256, min_size=65536),
                              telemetry=TEL_SPEC)
    params, _ = init_model(cfg, seed=0, device=cuda)
    state = {"params": params, "opt": adamw.init_opt_state(params),
             "tel": multisketch_empty(TEL_SPEC, device=cuda)}
    del params
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (8, 128)).astype(np.int32)).to(cuda)
    K.reset_launch_counts()
    state, m = step(state, {"tokens": toks})
    assert tuple(K.launch_counts().values()) == (9, 10, 1, 0, 0, 0)
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
    assert int(state["opt"]["step"]) == 1
    assert int(state["tel"].valid.sum()) == 8


# ------------------------------------------------------ MoE and decode
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen2-moe-a2.7b"])
def test_moe_and_decode_on_card_match_cpu(cuda, arch, monkeypatch):
    """A MoE smoke config on the card against the same calls on the CPU
    (qwen2-moe: shared experts, QKV bias, 60 experts): on an exact router
    (integer activations and router weights) the routing (top-k, slots,
    drops) is equal, bf16 and fp32; apply_moe's output within 1e-5 x
    scale in fp32 and 2e-2 in bf16; prefill and 4 serve steps in fp32
    within 1e-4 x scale of the CPU's logits."""
    import dataclasses
    from repro_torch import tree as TT
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as Mod
    from repro_torch.models import moe as MOE
    cfg = dataclasses.replace(get_smoke_config(arch), capacity_factor=0.5)
    params, _ = Mod.init_model(cfg, seed=3, device="cpu")
    lp = TT.tree_map(lambda t: t[0], params["layers"]["moe"])
    rng = np.random.default_rng(4)
    lp["router"] = torch.from_numpy(rng.integers(
        -1, 2, tuple(lp["router"].shape)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-1, 2, (2, 32, cfg.d_model)).astype(
        np.float32))
    on = lambda t: TT.tree_map(lambda a: a.to(cuda), t)
    for dt, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        a = MOE.route(lp, x.to(dt), cfg)
        b = MOE.route(on(lp), x.to(dt).to(cuda), cfg)
        for name in ("topi", "slot", "keep", "dest"):
            assert torch.equal(getattr(a, name), getattr(b, name).cpu()), name
        assert 0 < int(a.keep.sum()) < a.keep.numel()
        oa, _ = MOE.apply_moe(lp, x.to(dt), cfg)
        ob, _ = MOE.apply_moe(on(lp), x.to(dt).to(cuda), cfg)
        gap = float((oa.float() - ob.float().cpu()).abs().max())
        assert gap <= rel * float(oa.float().abs().max()), (dt, gap)
    old = Mod.ACT_DTYPE
    Mod.ACT_DTYPE = torch.float32
    _plain_attention(monkeypatch)
    try:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                .astype(np.int32))
        out = {}
        for dev in ("cpu", cuda):
            p = params if dev == "cpu" else on(params)
            logits, cache = Mod.prefill(p, cfg, {"tokens": toks.to(dev)})
            cache = Mod.grow_cache(cfg, cache, 4)
            steps = [logits]
            for t in range(4):
                logits, cache = Mod.serve_step(p, cfg, toks[:, t].to(dev),
                                               cache, 16 + t)
                steps.append(logits)
            out[str(dev)] = [s.cpu() for s in steps]
        for a, b in zip(out["cpu"], out[str(cuda)]):
            live = a > -1e29
            assert torch.equal(live, b > -1e29)
            assert float((a[live] - b[live]).abs().max()) <= 1e-4 * float(
                a[live].abs().max())
    finally:
        Mod.ACT_DTYPE = old


# ---------------------------------------------------- SSM and hybrid
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_families_on_card_match_cpu(cuda, arch, monkeypatch):
    """The smoke configs of the ssm (Mamba-1) and hybrid (Mamba-2 + the
    shared attention block) families on the card against the same calls
    on the CPU, with TF32 off: the forward logits, prefill and 8 serve
    steps (fixed tokens), in fp32 within 1e-4 x scale and in bf16 within
    5e-2 x scale (bf16 against fp32 on the CPU: 1.4e-2 at most); for
    zamba2 one train step on the card with the sampled exchange (every
    leaf of >= 1024 elements) and the telemetry fold: its loss within
    rtol 2e-2 of ``loss_fn`` on the CPU, launches (n + 1, n + 2, 1, 0, 0,
    0) for n sampled leaves. (The CPU side takes no mesh: a CPU mesh over
    a default group an earlier test made with NCCL has no CPU backend.)"""
    from repro_torch import tree as TT
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import multisketch_empty
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TEL_SPEC
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    old_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = Mod.ACT_DTYPE
    cfg = get_smoke_config(arch)
    params, _ = Mod.init_model(cfg, seed=3, device="cpu")
    on = lambda t: TT.tree_map(lambda a: a.to(cuda), t)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    V = cfg.vocab_size
    try:
        for dt, rel in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            Mod.ACT_DTYPE = dt
            if dt == torch.float32:
                _plain_attention(monkeypatch)
            else:
                monkeypatch.undo()
            out = {}
            for dev in ("cpu", cuda):
                p = params if dev == "cpu" else on(params)
                with torch.no_grad():
                    full = Mod.forward_logits(p, cfg, {"tokens": toks.to(dev)})
                logits, cache = Mod.prefill(p, cfg, {"tokens": toks.to(dev)})
                cache = Mod.grow_cache(cfg, cache, 8)
                got = [full[:, :, :V], logits[:, :V]]
                for t in range(8):
                    logits, cache = Mod.serve_step(
                        p, cfg, toks[:, t].to(dev), cache, 16 + t)
                    got.append(logits[:, :V])
                out[str(dev)] = [g.float().cpu() for g in got]
            for i, (a, b) in enumerate(zip(out["cpu"], out[str(cuda)])):
                assert bool(torch.isfinite(b).all()), (dt, i)
                gap = float((a - b).abs().max())
                assert gap <= rel * float(a.abs().max()), (dt, i, gap)
        if cfg.family != "hybrid":
            return
        Mod.ACT_DTYPE = old
        with torch.no_grad():
            want = float(Mod.loss_fn(params, cfg, {"tokens": toks})[0])
        mesh = Mesh((1, 1, 1), ("pod", "data", "model"), device=cuda)
        step, _ = make_train_step(cfg, adamw.OptConfig(), mesh,
                                  compress=dict(k=256, min_size=1024),
                                  telemetry=TEL_SPEC)
        p = on(params)
        state = {"params": p, "opt": adamw.init_opt_state(p),
                 "tel": multisketch_empty(TEL_SPEC, device=cuda)}
        K.reset_launch_counts()
        state, m = step(state, {"tokens": toks.to(cuda)})
        n = sum(1 for t in TT.leaves(params) if t.numel() >= 1024)
        assert tuple(K.launch_counts().values()) == (n + 1, n + 2, 1, 0, 0,
                                                     0)
        got = float(m["loss"])
        assert np.isfinite(got) and abs(got - want) <= 2e-2 * abs(want)
    finally:
        Mod.ACT_DTYPE = old
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old_tf32


# ------------------------------------------------------ encoder and vlm
class _Recorder:
    """A kernel wrapper that records its calls, inputs and outputs copied
    at the call. Its ``launches`` is the wrapped function's, which the
    kernel modules count through the module attribute this replaces."""

    def __init__(self, fn, name, calls):
        self._fn, self._name, self._calls = fn, name, calls

    def __call__(self, *a, **kw):
        inputs = _copied((a, kw))
        out = self._fn(*a, **kw)
        self._calls.append((self._name, inputs, _copied(out)))
        return out

    @property
    def launches(self):
        return self._fn.launches

    @launches.setter
    def launches(self, value):
        self._fn.launches = value


def _copied(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_copied(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(v) for v in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return x


def _record_path(monkeypatch):
    """Every call of the kernel wrappers the train and serve paths look up
    at call time, as (wrapper name, (args, kwargs), outputs)."""
    calls = []
    for mod, attr in ((ks, "fused_seeds_fvals"), (ks, "fused_seeds"),
                      (kbs, "batched_bottomk_select"),
                      (kc, "batched_bottomk_select"),
                      (kc, "retention_priority"),
                      (kq, "segment_query_slab"),
                      (ksc, "service_cost_slab")):
        monkeypatch.setattr(mod, attr, _Recorder(getattr(mod, attr), attr,
                                                 calls))
    return calls


def _assert_calls_match_plain(calls):
    """Each recorded launch against its kernel's plain version on the
    recorded inputs, at the tolerances above."""
    for i, (name, (a, kw), got) in enumerate(calls):
        what = f"{name} call {i}"
        if name == "fused_seeds_fvals":
            sp, fp = ks.fused_seeds_fvals_plain(*a, **kw)
            assert_ulp(got[0], sp, 2, what)
            assert_ulp(got[1], fp, 2, what)
        elif name == "fused_seeds":
            assert_ulp(got, ks.fused_seeds_fvals_plain(
                *a, **kw, want_fvals=False)[0], 2, what)
        elif name == "batched_bottomk_select":
            want = kbs.batched_bottomk_select_plain(*a, **kw)
            assert all(torch.equal(x, y) for x, y in zip(got, want)), what
        elif name == "retention_priority":
            assert torch.equal(got, kc.retention_priority_plain(*a, **kw)), \
                what
        elif name == "segment_query_slab":
            assert torch.allclose(got, kq.segment_query_slab_plain(*a, **kw),
                                  rtol=EST_RTOL, atol=0.0), what
        else:
            _assert_k5_close(got, ksc.service_cost_slab_plain(*a, **kw),
                             a[:3], a[3])


def test_encoder_train_step_on_card(cuda, monkeypatch):
    """One train step of hubert-smoke (bidirectional encoder over stub
    frames) on the card with the sampled exchange (every leaf of >= 1024
    elements, the unused token embedding's zero gradient among them) and
    the telemetry fold: launches (n + 1, n + 2, 1, 0, 0, 0) for n sampled
    leaves, each held against its plain version; the loss within rtol
    2e-2 of ``loss_fn`` on the CPU (bf16 on both)."""
    from repro_torch import tree as TT
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import multisketch_empty
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TEL_SPEC
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    cfg = get_smoke_config("hubert-xlarge")
    params, _ = Mod.init_model(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32)).to(torch.bfloat16),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (4, 32)).astype(np.int32))}
    with torch.no_grad():
        want = float(Mod.loss_fn(params, cfg, batch)[0])
    mesh = Mesh((1, 1, 1), ("pod", "data", "model"), device=cuda)
    step, _ = make_train_step(cfg, adamw.OptConfig(), mesh,
                              compress=dict(k=256, min_size=1024),
                              telemetry=TEL_SPEC)
    p = TT.tree_map(lambda a: a.to(cuda), params)
    state = {"params": p, "opt": adamw.init_opt_state(p),
             "tel": multisketch_empty(TEL_SPEC, device=cuda)}
    calls = _record_path(monkeypatch)
    K.reset_launch_counts()
    state, m = step(state, {k: v.to(cuda) for k, v in batch.items()})
    n = sum(1 for t in TT.leaves(params) if t.numel() >= 1024)
    assert tuple(K.launch_counts().values()) == (n + 1, n + 2, 1, 0, 0, 0)
    assert len(calls) == 2 * n + 4
    _assert_calls_match_plain(calls)
    got = float(m["loss"])
    assert np.isfinite(got) and abs(got - want) <= 2e-2 * abs(want)
    assert int(state["opt"]["step"]) == 1


def test_vlm_serve_main_on_card(cuda, monkeypatch):
    """serve.main --arch internvl2-76b --smoke on the card: 8 patches + 8
    prompt tokens, 4 generated from index 16; the request telemetry's
    launches (K1-K3 at absorb, K4 at query, K5 in the search) counted and
    each held against its plain version; the pool's estimates exact."""
    from repro_torch.launch import serve
    calls = _record_path(monkeypatch)
    K.reset_launch_counts()
    out = serve.main(["--arch", "internvl2-76b", "--smoke", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4"])
    counts = tuple(K.launch_counts().values())
    assert min(counts[:5]) > 0 and counts[5] == 0 and counts[3] == 1
    assert len(calls) == sum(counts)
    _assert_calls_match_plain(calls)
    assert out["tokens"].shape == (2, 4) and out["tokens"].max() < 128
    assert out["stats"][0, 0] == 2 * (8 + 4) and out["stats"][1, 0] == 2
