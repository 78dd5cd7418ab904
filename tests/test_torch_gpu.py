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
