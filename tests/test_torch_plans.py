"""The launch plans of the port's K4 (segment query) and K5 (service cost)
kernels, on the CPU: no card, no JAX.

A plan fixes how a launch splits the slab across blocks and so the order
in which a slot's contribution is summed. K4's comes from c alone and
K5's from (c, dim) alone: an answer's bits must never depend on the batch
size B or Q, on Cmax padding, or on which other predicates or sets share
a launch. K5 keeps the (dim, Cmax) domain of its first, one-block-per-set
design, so callers see the same errors.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import segquery as kq                # noqa: E402
from repro_torch.kernels import servicecost as ksc            # noqa: E402

K4_CHUNK = 1152         # slots segquery.cu stages per pass (Q_CHUNK)
SIZES = [0, 1, 2, 31, 127, 128, 129, 1023, 1024, 1025, 4098, 8201, 9216,
         9217, 65_536, 1_000_003]


def first_design_plan(dim, cmax):
    """K5's launch plan as first written (threads, shared bytes), raising
    ValueError where it did: the reference for the domain."""
    xst = dim | 1
    threads = next((t for t in (256, 128, 64, 32)
                    if 2 * t * xst * 4 <= 160 * 1024), None)
    if threads is None:
        raise ValueError("dim too large")
    cp = -(-cmax // 8) * 8
    smem = 4 * (dim * cp + 2 * cp + 2 * threads * xst + 32)
    if smem > 232_448:
        raise ValueError("centers do not fit")
    return threads, smem


def _slices_cover(c, slices, slice_len, most=8):
    assert 1 <= slices <= most
    assert slices * slice_len >= c
    if c:
        assert (slices - 1) * slice_len < c          # no empty slice
    else:
        assert (slices, slice_len) == (1, 0)


@pytest.mark.parametrize("c", SIZES)
def test_segquery_plan_covers_the_slab(c):
    slices, slice_len = kq.launch_plan(c)
    _slices_cover(c, slices, slice_len, kq.MAX_SLICES)
    if c <= kq.MAX_SLICES * kq.SLICE_TARGET:
        # up to 8192 slots a slice is at most SLICE_TARGET long
        assert slice_len <= kq.SLICE_TARGET
    if c >= kq.MAX_SLICES * kq.SLICE_TARGET:
        assert slices == kq.MAX_SLICES
    if c == 8201:
        # the serving slab: 16 slices, one staging pass each
        assert (slices, slice_len) == (16, 513) and slice_len <= K4_CHUNK


class _RecordingLib:
    """Stands in for the built kernel library: records each launch's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def recording(monkeypatch):
    """The wrappers' CUDA path driven with meta tensors (shapes, no data)
    into a recording library: what each launch is handed, without a
    card."""
    lib = _RecordingLib()
    for mod in (kq, ksc):
        monkeypatch.setattr(mod, "kernel_lib", lambda: lib)
        monkeypatch.setattr(mod, "check_cuda", lambda *a, **k: a[1])
        monkeypatch.setattr(mod, "stream_ptr", lambda dev: 0)
        monkeypatch.setattr(mod, "tile_tickets",
                            lambda dev, n: _meta(n, torch.int32))
    monkeypatch.setattr(kq.segment_query_slab, "launches", 0)
    monkeypatch.setattr(ksc.service_cost_slab, "launches", 0)
    return lib


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("c", [0, 1, 1025, 8201])
def test_segquery_launch_ignores_the_batch(recording, c):
    """One launch per call, with the same (slices, slice_len) at every B."""
    slab = (_meta(c, torch.int32), _meta(c), _meta(c), _meta(c, torch.bool))
    objs = ((0, 0.0), (1, 0.0), (4, 1.5))
    for b in (1, 7, 16, 17, 256, 1000):
        out = kq.segment_query_slab(*slab, _meta((b, 6), torch.int32), objs)
        assert tuple(out.shape) == (3, b)
    assert kq.segment_query_slab.launches == 6
    plans = {args[8:12] for name, args in recording.calls}
    bs = sorted(p[1] for p in plans)
    assert bs == [1, 7, 16, 17, 256, 1000]
    assert {(p[0], p[2], p[3]) for p in plans} == {(c, *kq.launch_plan(c))}


@pytest.mark.parametrize("c,dim", [(0, 68), (1, 3), (4098, 68),
                                   (4098, 639)])
def test_servicecost_launch_ignores_q_and_cmax(recording, c, dim):
    """One launch per call; slices, slice length, rows, stages, center
    chunk and shared memory the same at every Q and Cmax."""
    from repro_torch.core import costs as CO
    slab = (_meta((c, dim)), _meta(c), _meta(c, torch.bool))
    for q in (1, 7, 16, 128):
        for cmax in (1, 20, 24):
            table = CO.CostTable(_meta((q, cmax, dim)),
                                 _meta((q, cmax), torch.bool), _meta(q),
                                 _meta(q), _meta(q, torch.int32))
            assert tuple(ksc.service_cost_slab(*slab, table).shape) == (q,)
    assert ksc.service_cost_slab.launches == 12
    plans = {args[16:22] for name, args in recording.calls}
    assert plans == {tuple(ksc.launch_plan(c, dim, 1)[:5])
                     + (ksc.launch_plan(c, dim, 1).smem,)}


@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5, 8, 17, 68, 76, 77, 100,
                                 320, 321, 639])
@pytest.mark.parametrize("c", [0, 1, 100, 4098, 65_536])
def test_servicecost_plan_depends_on_c_and_dim_only(c, dim):
    plans = {ksc.launch_plan(c, dim, cmax)
             for cmax in range(1, 65) if ksc.supported(dim, cmax)}
    assert len(plans) == 1
    plan = plans.pop()
    _slices_cover(c, plan.slices, plan.slice_len)
    assert plan.threads == ksc.THREADS == 32 * ksc.SETS
    assert plan.rows in (1, 2, 4) and plan.stages in (1, 2)
    assert plan.cpcap % 8 == 0 and 8 <= plan.cpcap <= 64
    st = 4 * (-(-dim // 4) | 1)
    assert st % 8 == 4 and st >= dim        # float4 rows, no conflicts
    assert plan.smem == 4 * (plan.stages * 32 * plan.rows * (st + 1)
                             + ksc.SETS * plan.cpcap * (st + 2))
    assert plan.smem <= ksc.SMEM_MAX


def test_servicecost_plan_at_the_metric_tier_shape():
    """c = 4098, dim = 68: 8 slices of 513 slots, 128-slot point tiles in
    two buffers, a 20-center set staged in one chunk, and two blocks per
    SM (228 KB of shared memory, 1 KB reserved per block)."""
    plan = ksc.launch_plan(4098, 68, 20)
    assert (plan.slices, plan.slice_len) == (8, 513)
    assert (plan.rows, plan.stages, plan.threads) == (4, 2, 128)
    assert plan.cpcap >= 20
    assert 2 * (plan.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("dim_lo", list(range(1, 641, 64)))
def test_servicecost_domain_matches_the_first_design(dim_lo):
    """On dim 1-640 x Cmax 1-64 the plan accepts exactly what the first
    design accepted and raises ValueError exactly where it raised."""
    for dim in range(dim_lo, min(dim_lo + 64, 641)):
        for cmax in range(1, 65):
            try:
                first_design_plan(dim, cmax)
                ok = True
            except ValueError:
                ok = False
            assert ksc.supported(dim, cmax) == ok, (dim, cmax)
            if ok:
                ksc.launch_plan(4098, dim, cmax)
            else:
                with pytest.raises(ValueError):
                    ksc.launch_plan(4098, dim, cmax)


@pytest.mark.parametrize("c", [0, 1, 31, "tile"])
@pytest.mark.parametrize("dim", [3, 68, 639])
def test_small_slabs_give_a_valid_plan(c, dim):
    """c = 0 and c up to one point tile (32 x rows slots): one slice
    holding the whole slab (the kernel then writes zeros or the few
    slots' sums)."""
    if c == "tile":
        c = 32 * ksc.launch_plan(0, dim, 1).rows
    plan = ksc.launch_plan(c, dim, 1)
    assert plan.slices == 1 and plan.slice_len == c
    assert kq.launch_plan(c) == (1, c)


def test_cpu_tensors_never_reach_a_plan(monkeypatch):
    """On the CPU the wrappers take their plain versions: no plan, no
    launch (a plan that raised would show here)."""
    def boom(*a, **k):
        raise AssertionError("launch_plan called for CPU tensors")
    monkeypatch.setattr(ksc, "launch_plan", boom)
    monkeypatch.setattr(kq, "launch_plan", boom)
    from repro_torch.core import costs as CO
    from repro_torch.core import predicates as P
    g = torch.Generator().manual_seed(0)
    pts = torch.randn((50, 3), generator=g)
    probs = torch.full((50,), 0.5)
    member = torch.ones(50, dtype=torch.bool)
    table = CO.CostTable(torch.randn((2, 4, 3), generator=g),
                         torch.ones((2, 4), dtype=torch.bool),
                         torch.ones(2), torch.ones(2),
                         torch.zeros(2, dtype=torch.int32))
    assert ksc.service_cost_slab(pts, probs, member, table).shape == (2,)
    keys = torch.arange(50, dtype=torch.int32)
    ptab = torch.from_numpy(P.encode_predicates([P.EVERYTHING]))
    out = kq.segment_query_slab(keys, probs, probs, member, ptab,
                                ((0, 0.0),))
    assert out.shape == (1, 1)
