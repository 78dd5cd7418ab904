"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the card. Imports neither JAX nor the reference, so it runs on
a machine with a CUDA build of PyTorch and nvcc alone (it imports no other
test module either: a site-packages ``tests`` package may shadow ours):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test carries the ``gpu`` marker and skips where there is no card.
Tolerances: one libm on both sides, so seeds and f-values within 2 ulp
(measured 0), selections and priorities exact, estimates rtol 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.kernels as K                               # noqa: E402
from repro_torch.kernels import blockselect as kbs            # noqa: E402
from repro_torch.kernels import compact as kc                 # noqa: E402
from repro_torch.kernels import seeds as ks                   # noqa: E402
from repro_torch.kernels import segquery as kq                # noqa: E402
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
