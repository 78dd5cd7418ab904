"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the card. Imports neither JAX nor the reference, so it runs on
a machine with a CUDA build of PyTorch and nvcc alone (it imports no other
test module either: a site-packages ``tests`` package may shadow ours):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test carries the ``gpu`` marker and skips where there is no card.
Tolerances: one libm on both sides, so seeds and f-values within 2 ulp
(measured 0), selections and priorities exact, estimates rtol 1e-5; K5's
ball-mode estimates within that rtol plus the HT weight of the slots whose
d2 lies within 8 eps32 (|x|^2 + |c|^2) of r^2 (the two sides sum the dot
products in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.kernels as K                               # noqa: E402
from repro_torch.kernels import blockselect as kbs            # noqa: E402
from repro_torch.kernels import compact as kc                 # noqa: E402
from repro_torch.kernels import seeds as ks                   # noqa: E402
from repro_torch.kernels import segquery as kq                # noqa: E402
from repro_torch.kernels import servicecost as ksc            # noqa: E402
from repro_torch.core import costs as CO                      # noqa: E402
from repro_torch.core import predicates as P                  # noqa: E402

pytestmark = pytest.mark.gpu
EST_RTOL = 1e-5

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
