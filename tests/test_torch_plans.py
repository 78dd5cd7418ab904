"""The launch plans of the port's K4 (segment query), K5 (service cost) and
K2 (global bottom-k select) kernels, and K6's launch, on the CPU: no card,
no JAX.

A plan fixes how a launch splits the slab across blocks and so the order
in which a slot's contribution is summed. K4's comes from c alone and
K5's from (c, dim) alone: an answer's bits must never depend on the batch
size B or Q, on Cmax padding, or on which other predicates or sets share
a launch. K5 keeps the (dim, Cmax) domain of its first, one-block-per-set
design, so callers see the same errors.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import blockselect as kbs            # noqa: E402
from repro_torch.kernels import rankcount as krc              # noqa: E402
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
    card. The wrappers' meta branch (a dry run's) is switched off, so the
    meta tensors take the CUDA route."""
    lib = _RecordingLib()
    lib.tickets = []
    for mod in (kq, ksc, kbs, krc):
        monkeypatch.setattr(mod, "kernel_lib", lambda: lib)
        monkeypatch.setattr(mod, "check_cuda", lambda *a, **k: a[1])
        monkeypatch.setattr(mod, "stream_ptr", lambda dev: 0)
    for mod in (kq, kbs, krc):
        monkeypatch.setattr(mod, "on_meta", lambda x: False)
    for mod in (kq, ksc, kbs):
        monkeypatch.setattr(mod, "tile_tickets", lambda dev, n: (
            lib.tickets.append(n), _meta(n, torch.int32))[1])
    monkeypatch.setattr(kq.segment_query_slab, "launches", 0)
    monkeypatch.setattr(ksc.service_cost_slab, "launches", 0)
    monkeypatch.setattr(kbs.batched_block_bottomk, "launches", 0)
    monkeypatch.setattr(krc.rank_counts, "launches", 0)
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


# ----------------------------------------------------------------------- K2
# (F, n, k): the main path's two shapes (multisketch_select, compact_take),
# n <= k, n = k + 1, and ragged n around the span and block sizes
SELECT_SHAPES = [(8, 1_056_777, 1025), (1, 1_056_777, 8201), (8, 1, 1),
                 (1, 100, 5), (8, 100, 1025), (8, 2049, 2048),
                 (1, 2049, 2049), (8, 5000, 8202), (3, 5000, 1),
                 (1, 8202, 8201), (8, 65_536, 64), (1, 1_000_003, 0),
                 (2, 100_000, 16_383), (2, 100_000, 20_000)]


def _reference_width(n, k):
    """The candidate width and output width of ``select_from_candidates``
    over the per-span route's candidates (the reference's)."""
    ksel = min(k + 1, n)
    nb = -(-max(n, 1) // kbs._span(n))
    m = min(k + 1, nb * ksel)
    return m, min(k, m)


@pytest.mark.parametrize("nf,n,k", SELECT_SHAPES)
def test_select_plan_covers_each_row(nf, n, k):
    """q = min(k + 1, n) candidates, the reference's width m, blocks whose
    chunks of whole warp segments cover the row with none empty, and
    about TARGET_BLOCKS blocks in all once rows are long."""
    plan = kbs.select_plan(nf, n, k)
    assert plan.q == min(k + 1, n)
    assert (plan.m, plan.width) == _reference_width(n, k)
    assert plan.m >= plan.q
    assert plan.ranked == (plan.q <= kbs.RANK_Q_MAX)
    assert plan.chunk % kbs.SELECT_THREADS == 0
    assert plan.blocks <= max(1, -(-n // kbs.MIN_CHUNK))
    assert plan.blocks * plan.chunk >= n
    assert (plan.blocks - 1) * plan.chunk < max(n, 1)
    assert plan.scratch == nf * (kbs.SELECT_BINS + 1)
    if n >= kbs.MIN_CHUNK * kbs.TARGET_BLOCKS:
        assert nf * plan.blocks <= kbs.TARGET_BLOCKS + nf
    if (nf, n, k) == (8, 1_056_777, 1025):
        assert (plan.q, plan.blocks, plan.chunk) == (1026, 130, 8192)


@pytest.mark.parametrize("nf,n,k", SELECT_SHAPES)
def test_select_launch_follows_the_plan(recording, nf, n, k):
    """``batched_bottomk_select`` on meta tensors (shapes, no contents)
    into a recording library: one launch, handed (F, n, q, m, k, blocks,
    chunk, ranked) of ``select_plan`` and a zeroed scratch of its size, and
    output widths of the reference (sorted by the kernel up to RANK_Q_MAX
    candidates, by torch.sort past it). A meta tensor has no contents, so the wrapper reads
    none of the seeds (no host synchronisation) and its launch cannot
    depend on them."""
    vals, idx, tau = kbs.batched_bottomk_select(_meta((nf, n)), k)
    plan = kbs.select_plan(nf, n, k)
    width = _reference_width(n, k)[1]
    assert tuple(vals.shape) == tuple(idx.shape) == (nf, width)
    assert tuple(tau.shape) == (nf,)
    assert kbs.batched_block_bottomk.launches == 1
    [(name, args)] = recording.calls
    assert name == "repro_select"
    assert args[9:17] == (nf, n, plan.q, plan.m, k, plan.blocks, plan.chunk,
                          int(plan.ranked))
    assert recording.tickets == [plan.scratch]


def test_select_launch_of_the_main_path_callers(recording):
    """multisketch_select's and compact_take's selects go through the
    global route with the main path's plans."""
    n = 1_056_777
    kbs.batched_bottomk_select(_meta((8, n)), 1025)
    from repro_torch.kernels import compact as kc
    take, valid = kc._take(_meta(n), 8201, kbs.batched_bottomk_select)
    assert tuple(take.shape) == tuple(valid.shape) == (8201,)
    sel = [args[9:17] for name, args in recording.calls]
    want = [kbs.select_plan(8, n, 1025), kbs.select_plan(1, n, 8201)]
    assert sel == [(f, n, p.q, p.m, k, p.blocks, p.chunk, 1)
                   for f, k, p in zip((8, 1), (1025, 8201), want)]


def test_select_empty_rows_launch_nothing(recording):
    vals, idx, tau = kbs.batched_bottomk_select(_meta((8, 0)), 1025)
    assert vals.shape == (8, 0) and tau.shape == (8,)
    assert recording.calls == []


# ----------------------------------------------------------------------- K6
@pytest.mark.parametrize("n", [1, 2048, 2049, 65_536, 1_000_003])
def test_rankcount_launch_takes_no_host_sync(recording, n):
    """K6 on meta tensors: the order reduction and one call into the
    kernel library (its merge levels follow from n), no read of the
    contents."""
    w = _meta(n)
    h, l = krc.rank_counts(w, w, w, _meta(n, torch.bool))
    assert tuple(h.shape) == tuple(l.shape) == (n,)
    assert krc.rank_counts.launches == 1
    [(name, args)] = recording.calls
    assert name == "repro_rankcount" and args[4] == n


def test_cpu_selects_never_reach_a_plan(monkeypatch):
    """On the CPU K2 and K6 take their plain versions: no plan, no
    launch."""
    def boom(*a, **k):
        raise AssertionError("select_plan called for CPU tensors")
    monkeypatch.setattr(kbs, "select_plan", boom)
    monkeypatch.setattr(krc, "rank_counts_by_order", boom)
    s = torch.rand((2, 300), generator=torch.Generator().manual_seed(0))
    for a, b in zip(kbs.batched_bottomk_select(s, 7),
                    kbs.batched_bottomk_select_plain(s, 7)):
        assert torch.equal(a, b)
    act = torch.ones(300, dtype=torch.bool)
    h, l = krc.rank_counts(s[0], s[1], s[0], act)
    assert h.shape == (300,)
