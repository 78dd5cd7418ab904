"""Metric-space clustering engine (the second serving tier, paper §7).

Port of ``repro/launch/cluster.py``. A query is a candidate center set C
and the answer is the HT estimate of its clustering cost
Sum_x min_{c in C} d(x, c)^mu (or ball coverage). The engine keeps on its
device:

  * a ``MultiSketch`` over point keys whose weights are the anchor-based
    universal upper-bound probabilities (core.metric_domains); absorbing a
    chunk is the streaming fold through K1-K3;
  * a coords slab [cap, dim] ALIGNED slot by slot with the sketch
    (realigned after every fold: sorts, searchsorted and one gather), so
    K5 (kernels.servicecost) reads coordinates and HT weights from the
    same resident tensors;
  * anchor normalizers frozen at the first chunk, keeping ppswor seeds
    comparable across chunks.

``service_costs`` answers a Q-batch of candidate sets in one K5 launch per
``q_max`` rows, each padded to a ``q_quantum`` bucket with null rows.

On top rides the paper's optimization meta-algorithm (compute a sample
once, then optimize over estimated costs): :func:`local_search`, where all
candidate swaps of a round are scored as one Q-batch, and :func:`kcenter`,
a farthest-point 2-approximation on the member slots validated by ball
coverage.

Every fold allocates a fresh slab (``core.multi_sketch``), so arrays handed
out by ``sample()`` stay valid across later absorbs.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.costs import (CostTable, ball_query, cost_query,
                                    cost_table, encode_cost_queries,
                                    estimate_service_costs,
                                    exact_service_costs, pad_cost_table,
                                    points_to)
from repro_torch.core.funcs import SUM
from repro_torch.core.metric_domains import (anchor_upper_weights,
                                             farthest_point_anchors)
from repro_torch.core.multi_sketch import (MultiSketch, MultiSketchSpec,
                                           multisketch_absorb,
                                           multisketch_empty,
                                           multisketch_overflow)


def _sorted_lookup(cand_keys, cand_coords, queries):
    """(hit [n] bool, rows [n, dim]): each query key's coords among the
    candidate (key, coord) rows, the sort + searchsorted + gather core of
    every realignment path. Negative query keys never hit."""
    order = torch.argsort(cand_keys, stable=True)
    sk = cand_keys[order]
    pos = torch.clamp(torch.searchsorted(sk, queries), 0, sk.shape[0] - 1)
    hit = (sk[pos] == queries) & (queries >= 0)
    return hit, cand_coords[order[pos]]


def _align_coords(new_keys, cand_keys, cand_coords):
    """Coords for each slab slot, looked up among candidate (key, coord)
    rows."""
    hit, rows = _sorted_lookup(cand_keys, cand_coords, new_keys)
    return torch.where(hit[:, None], rows, torch.zeros_like(rows))


def _align_coords_delta(new_keys, old_keys, old_coords, chunk_keys,
                        chunk_coords):
    """Delta-aware realignment: a slot whose key did not move REUSES its
    coords row; only moved slots are looked up, in the old slab and in the
    chunk separately. Equal to ``_align_coords`` over the concatenated
    candidates, because a re-absorbed key must present the same coordinates
    (ClusterEngine.absorb contract)."""
    same = (new_keys == old_keys) & (new_keys >= 0)
    moved = torch.where(same, torch.full_like(new_keys, -1), new_keys)
    ohit, orows = _sorted_lookup(old_keys, old_coords, moved)
    chit, crows = _sorted_lookup(chunk_keys, chunk_coords, moved)
    looked = torch.where(ohit[:, None], orows,
                         torch.where(chit[:, None], crows,
                                     torch.zeros_like(crows)))
    return torch.where(same[:, None], old_coords, looked)


class ClusterReplica(NamedTuple):
    """Portable snapshot of a ClusterEngine's resident state (deep copies):
    the hand-off unit of follower promotion, see ``ClusterEngine.handoff``."""

    sketch: object            # MultiSketch slab
    coords: object            # [cap, dim] aligned coords
    anchor_coords: object     # frozen anchors (None before the first absorb)
    eps: object               # frozen distance regularizer
    norm: object              # frozen per-anchor column sums
    next_key: int
    epoch: int
    config: dict              # constructor kwargs of the source engine


def _clone(x):
    return None if x is None else x.clone()


class ClusterEngine:
    """Resident sampled point slab + batched service-cost queries.

    ``k`` is the slab sample-size budget (the bottom-k parameter over the
    anchor upper-bound weights). Points are unit-weight. ``device=None``
    is the CUDA card (raises without one); ``device="cpu"`` runs the plain
    PyTorch versions of the kernels.
    """

    def __init__(self, dim: int, k: int = 64, mu: float = 2.0,
                 n_anchors: int = 8, scheme: str = "ppswor", seed: int = 0,
                 chunk: int = 256, q_quantum: int = 16, q_max: int = 128,
                 use_kernels: Optional[bool] = None, device=None):
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.k = int(k)
        self.mu = float(mu)
        self.n_anchors = int(n_anchors)
        self.chunk = int(chunk)
        self.q_quantum = int(q_quantum)
        self.q_max = int(q_max)   # rows per K5 launch
        self.use_kernels = use_kernels
        self.spec = MultiSketchSpec(objectives=((SUM, self.k),),
                                    scheme=scheme, seed=seed)
        self._sketch = multisketch_empty(self.spec, device=self.device)
        self._coords = torch.zeros((self.spec.cap, self.dim),
                                   dtype=torch.float32, device=self.device)
        self._anchor_coords = None   # [m, dim] frozen at first absorb
        self._eps = None             # frozen distance regularizer
        self._norm = None            # frozen per-anchor column sums
        self._epoch = 0
        self._next_key = 0
        self.merge_stats = {"absorb_time": 0, "bytes_resident": 0}
        self._update_gauges()

    @classmethod
    def fit(cls, X, **kw) -> "ClusterEngine":
        """One-shot engine over a full point set."""
        X = np.asarray(X, np.float32)
        eng = cls(dim=X.shape[1], **kw)
        eng.absorb(X)
        return eng

    # -- resident state ----------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def anchors(self):
        return self._anchor_coords

    @property
    def overflow(self) -> bool:
        """True iff the resident slab is full, i.e. compaction may have
        truncated the sample (a device -> host read)."""
        return bool(multisketch_overflow(self._sketch))

    def absorb(self, points, keys=None):
        """Fold a chunk of points into the resident slab (fold + coords
        realignment). ``keys`` default to a running global index;
        re-absorbing a key must present the same coordinates."""
        P = points_to(points, self.device).reshape(-1, self.dim)
        b = P.shape[0]
        if self._anchor_coords is None:
            a_idx, _ = farthest_point_anchors(P, min(self.n_anchors, b))
            self._anchor_coords = P[a_idx.long()]
            _, self._eps, self._norm = anchor_upper_weights(
                P, self._anchor_coords, self.mu)
        v, _, _ = anchor_upper_weights(P, self._anchor_coords, self.mu,
                                       eps=self._eps, norm=self._norm)
        if keys is None:
            keys = np.arange(self._next_key, self._next_key + b,
                             dtype=np.int32)
            self._next_key += b
        else:
            # keep the default-key counter ahead of explicit ids, so a later
            # default-keyed absorb can never alias different points
            keys = np.asarray(keys, np.int32).reshape(-1)
            self._next_key = max(self._next_key, int(keys.max()) + 1)
        # pad to the chunk quantum on the device (keys -1, weight 0,
        # inactive), as the reference's host ``pad_chunk`` does
        npad = max(self.chunk, -(-b // self.chunk) * self.chunk) - b
        kt = torch.nn.functional.pad(
            torch.from_numpy(keys).to(self.device), (0, npad), value=-1)
        vt = torch.nn.functional.pad(v, (0, npad))
        act = torch.arange(b + npad, device=self.device) < b
        Ppad = torch.nn.functional.pad(P, (0, 0, 0, npad))
        old_keys, old_coords = self._sketch.keys, self._coords
        self._sketch = multisketch_absorb(self._sketch, kt, vt, act,
                                          spec=self.spec,
                                          use_kernels=self.use_kernels)
        self._coords = _align_coords_delta(self._sketch.keys, old_keys,
                                           old_coords, kt, Ppad)
        self._epoch += 1
        self.merge_stats["absorb_time"] += 1
        self._update_gauges()

    def _update_gauges(self):
        """Device residency gauge (host-side, no sync): slab + coords."""
        self.merge_stats["bytes_resident"] = (
            sum(x.numel() * x.element_size() for x in self._sketch)
            + self._coords.numel() * self._coords.element_size())

    def sample(self):
        """(coords [cap, dim], probs [cap], member [cap]): the resident slab
        K5 consumes. The tensors stay valid across later ``absorb`` calls
        (every fold allocates new ones)."""
        return self._coords, self._sketch.probs, self._sketch.member

    def total_count(self) -> float:
        """HT estimate of the number of absorbed points."""
        return float(torch.sum(torch.where(
            self._sketch.member,
            1.0 / torch.clamp_min(self._sketch.probs, 1e-30),
            torch.zeros_like(self._sketch.probs))))

    # -- replica hand-off (follower promotion) -------------------------------
    def handoff(self) -> ClusterReplica:
        """Deep-copied portable replica of the resident state. The FROZEN
        anchor normalizers (anchor coords, eps, per-anchor column sums) ride
        along with the slab: they keep ppswor seeds comparable across
        chunks, so the promoted engine serves bit-identical
        ``service_costs`` and keeps absorbing bit-identically to the
        source."""
        return ClusterReplica(
            sketch=MultiSketch(*(x.clone() for x in self._sketch)),
            coords=self._coords.clone(),
            anchor_coords=_clone(self._anchor_coords),
            eps=_clone(self._eps), norm=_clone(self._norm),
            next_key=self._next_key, epoch=self._epoch,
            config={"dim": self.dim, "k": self.k, "mu": self.mu,
                    "n_anchors": self.n_anchors,
                    "scheme": self.spec.scheme, "seed": self.spec.seed,
                    "chunk": self.chunk, "q_quantum": self.q_quantum,
                    "q_max": self.q_max})

    @classmethod
    def from_handoff(cls, replica: ClusterReplica,
                     use_kernels: Optional[bool] = None,
                     device=None) -> "ClusterEngine":
        """Promote a handed-off replica to a serving engine on ``device``
        (default the card). See ``handoff`` for the coordination
        contract."""
        eng = cls(use_kernels=use_kernels, device=device, **replica.config)
        to = lambda x: None if x is None else x.to(  # noqa: E731
            eng.device, copy=True)
        eng._sketch = MultiSketch(*(to(x) for x in replica.sketch))
        eng._coords = to(replica.coords)
        eng._anchor_coords = to(replica.anchor_coords)
        eng._eps = to(replica.eps)
        eng._norm = to(replica.norm)
        eng._next_key = int(replica.next_key)
        eng._epoch = int(replica.epoch)
        eng._update_gauges()
        return eng

    # -- batched queries -----------------------------------------------------
    def service_costs(self, queries) -> np.ndarray:
        """HT clustering-cost / ball-density estimates for a Q-batch of
        service-cost queries -> float32 numpy [Q]: one K5 launch per
        ``q_max`` rows regardless of Cmax, each padded to a multiple of
        ``q_quantum`` with null rows; one device -> host copy at the end."""
        table = CostTable(*(np.asarray(x)
                            for x in encode_cost_queries(queries)))
        q = table.mu.shape[0]
        parts = []
        for s in range(0, q, self.q_max):
            part = CostTable(*(x[s:s + self.q_max] for x in table))
            qp = part.mu.shape[0]
            qpad = max(self.q_quantum,
                       -(-qp // self.q_quantum) * self.q_quantum)
            est = estimate_service_costs(
                self._coords, self._sketch.probs, self._sketch.member,
                pad_cost_table(part, qpad), use_kernels=self.use_kernels)
            parts.append(est[:qp])
        return torch.cat(parts).cpu().numpy()

    def clustering_cost(self, centers, mu: Optional[float] = None) -> float:
        """Estimated Sum_x min_{c in centers} d(x, c)^mu for ONE set."""
        return float(self.service_costs(
            cost_query(centers, self.mu if mu is None else mu))[0])

    def ball_density(self, center, r: float) -> float:
        """Estimated |{x : d(x, center-set) <= r}| for ONE set."""
        return float(self.service_costs(ball_query(center, r))[0])


# ---------------------------------------------------------------------------
# the optimization meta-algorithm (sample once, optimize over estimates)
# ---------------------------------------------------------------------------

class ClusterResult(NamedTuple):
    centers: np.ndarray     # [k, dim]
    est_cost: float         # scorer cost of the returned set
    history: List[float]    # accepted cost per round (history[0] = init)
    rounds: int             # swap rounds taken


def exact_scorer(X, point_weights=None, device=None
                 ) -> Callable[[CostTable], np.ndarray]:
    """Ground-truth scorer over the FULL point set (host points go to
    ``device``, default the card): the oracle the sample-based search is
    cross-checked against."""
    X = points_to(X, device)

    def score(table: CostTable) -> np.ndarray:
        return exact_service_costs(X, table,
                                   point_weights=point_weights).cpu().numpy()
    return score


def _member_coords(engine: ClusterEngine) -> torch.Tensor:
    return engine._coords[engine._sketch.member]


def _candidate_pool(engine: ClusterEngine, n_cand: int) -> np.ndarray:
    """Deterministic candidate center locations: member slots strided
    evenly across the slab. Slab order is retention priority (sampling
    weight desc), so a PREFIX would be all outliers; the stride covers the
    whole weight range, cluster cores included."""
    cand = _member_coords(engine).cpu().numpy()
    m = cand.shape[0]
    if m == 0:
        raise ValueError("empty sample — absorb points first")
    if m <= n_cand:
        return cand
    return cand[np.unique(np.linspace(0, m - 1, n_cand).astype(int))]


def _swap_sets(cur: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """One round's batch [1 + k * ncand, k, dim]: row 0 the current set,
    row 1 + i * ncand + j the current set with center i swapped for
    candidate j."""
    k, ncand = cur.shape[0], cand.shape[0]
    sets = np.broadcast_to(cur, (k * ncand, k, cur.shape[1])).copy()
    sets = sets.reshape(k, ncand, k, -1)
    for i in range(k):
        sets[i, :, i, :] = cand
    return np.concatenate([cur[None], sets.reshape(k * ncand, k, -1)])


def local_search(engine: ClusterEngine, k: int, mu: Optional[float] = None,
                 rounds: int = 16, n_cand: int = 32, tol: float = 1e-3,
                 scorer: Optional[Callable] = None) -> ClusterResult:
    """Sample-based swap local search for k-median (mu=1) / k-means (mu=2).

    Candidates are the engine's member slots; every round scores the
    current set plus ALL k x n_cand single swaps as ONE service-cost
    Q-batch, accepts the best improving swap, and stops when no swap
    improves by ``tol`` relatively. ``scorer`` defaults to the engine's
    K5 estimator; pass :func:`exact_scorer` to run the identical search on
    ground-truth costs.
    """
    mu = engine.mu if mu is None else float(mu)
    if scorer is None:
        scorer = engine.service_costs
    cand = _candidate_pool(engine, n_cand)
    ncand = cand.shape[0]
    k = min(k, ncand)
    # deterministic k-center init over the candidate pool
    init_idx, _ = farthest_point_anchors(
        torch.from_numpy(cand).to(engine.device), k)
    cur = cand[init_idx.cpu().numpy()]                       # [k, dim]

    history = [float(np.asarray(scorer(cost_table(cur[None], mu)))[0])]
    for _ in range(rounds):
        scores = np.asarray(scorer(cost_table(_swap_sets(cur, cand), mu)))
        best = int(np.argmin(scores[1:])) + 1
        if scores[best] < scores[0] * (1.0 - tol):
            i, j = divmod(best - 1, ncand)
            cur = cur.copy()
            cur[i] = cand[j]
            history.append(float(scores[best]))
        else:
            break
    return ClusterResult(centers=cur, est_cost=history[-1],
                         history=history, rounds=len(history) - 1)


class KCenterResult(NamedTuple):
    centers: np.ndarray   # [k, dim]
    radius: float         # max sample-point distance to the centers
    coverage_est: float   # HT estimate of points within ``radius``
    total_est: float      # HT estimate of |X| (coverage should match)


def kcenter(engine: ClusterEngine, k: int) -> KCenterResult:
    """Sample-based greedy k-center (2-approx farthest-point on the member
    slots) + ball-coverage validation through K5: at the returned radius
    the estimated coverage should match the estimated total count."""
    pts = _member_coords(engine)
    k = min(k, pts.shape[0])
    idx, d_min = farthest_point_anchors(pts, k)
    centers = pts[idx.long()].cpu().numpy()
    radius = float(torch.max(d_min))
    cov = engine.ball_density(centers, radius * (1 + 1e-5))
    return KCenterResult(centers=centers, radius=radius, coverage_est=cov,
                         total_est=engine.total_count())
