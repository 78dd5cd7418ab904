"""Streaming telemetry via mergeable multi-objective summaries.

Port of ``repro/telemetry/stats.py``. Any stream of (key, weight) pairs
produced during training or serving — per-token losses, per-example grad
norms, router loads, request sizes — is folded into a fixed-capacity
``MultiSketch`` (core.multi_sketch). Sketches merge exactly across steps,
across collectors and across hosts, after which any f-statistic over any
key segment is one HT sum away: "how many tokens had loss >= 5?", "total
loss mass in domain d?" — all from one resident sketch, long after the
raw stream is gone.

``StatsCollector`` is the thin host wrapper: it pads ragged batches to a
quantum, owns the device-resident state, and routes predicate queries
through the batched segment-query path (``multisketch_query_many``: one K4
launch for any number of objectives x predicates). Arbitrary-callable
``segment_fn`` queries take ``sketch_estimate``. ``StatsCollector(cfg,
device=None)`` keeps its state on the CUDA card (raises without one);
``device="cpu"`` keeps it on the CPU.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (COUNT, SUM, MultiSketch, MultiSketchSpec,
                              multisketch_absorb, multisketch_empty,
                              multisketch_merge, multisketch_overflow,
                              multisketch_query_many, multisketch_slab_bytes,
                              sketch_estimate)
from repro_torch.core.funcs import StatFn
from repro_torch.core.multi_sketch import pad_chunk
from repro_torch.core.predicates import EVERYTHING, SegmentPredicate


@dataclasses.dataclass
class TelemetryConfig:
    k: int = 64          # per-objective sample size for default objectives
    capacity: int = 1024
    seed: int = 1234
    scheme: str = "ppswor"
    # objectives default to ((SUM, k), (COUNT, k)): mass + support queries
    objectives: Tuple[Tuple[StatFn, int], ...] = ()
    chunk: int = 256     # absorb pad quantum

    def spec(self) -> MultiSketchSpec:
        objs = self.objectives or ((SUM, self.k), (COUNT, self.k))
        return MultiSketchSpec(objectives=objs, scheme=self.scheme,
                               seed=self.seed, capacity=self.capacity)


class StatsCollector:
    """Host handle on a device-resident mergeable multi-objective sample.

    ``absorb(keys, weights)`` folds a batch of keyed observations into the
    resident state; ``query(f, segment_fn)`` estimates Q(f, H). Keys must
    be globally unique per observation (e.g. step * batch + position,
    staying within int32) — shared hashing makes the same key land
    identically on every host, so cross-host merges stay exact. A key
    REPEATED across absorbs is treated as the same element re-observed and
    keeps its max weight.
    """

    def __init__(self, cfg: TelemetryConfig, device=None):
        self.cfg = cfg
        self.spec = cfg.spec()
        self.device = resolve_device(device)
        self.state: MultiSketch = multisketch_empty(self.spec,
                                                    device=self.device)
        self._overflow_warned = False

    # -- streaming fold ----------------------------------------------------
    def absorb(self, keys, weights):
        keys, weights, active = pad_chunk(keys, weights,
                                          chunk=self.cfg.chunk)
        self.state = multisketch_absorb(self.state, keys, weights, active,
                                        spec=self.spec)

    def merge_from(self, other: "StatsCollector"):
        assert other.spec == self.spec, "collectors must share a spec"
        self.state = multisketch_merge(self.spec, self.state, other.state)

    # -- queries -----------------------------------------------------------
    def query(self, f: StatFn, segment_fn=None) -> float:
        """Estimate Q(f, H); segment_fn: a ``SegmentPredicate`` (the
        batched path) or any vectorized key callable (``sketch_estimate``
        over the slab)."""
        if segment_fn is None or isinstance(segment_fn, SegmentPredicate):
            pred = EVERYTHING if segment_fn is None else segment_fn
            return float(self.query_many((f,), (pred,))[0, 0])
        return float(sketch_estimate(self.state, f, segment_fn))

    def query_many(self, fs: Sequence[StatFn],
                   predicates=(EVERYTHING,)) -> np.ndarray:
        """Q(f_i, H_b) for a whole query batch -> float [|F|, B]: one
        batched estimate over the resident slab."""
        self._warn_if_overflowed()
        return multisketch_query_many(self.state, fs, predicates)

    @property
    def overflow(self) -> bool:
        """True iff the pool saturated — compaction may have truncated
        S ∪ Z, silently degrading cv below the Thm 3.1 guarantee."""
        return bool(multisketch_overflow(self.state))

    def _warn_if_overflowed(self):
        # checked at query time (one device read per query batch, not one
        # per absorb on the fold path); warns ONCE per collector
        if not self._overflow_warned and self.overflow:
            self._overflow_warned = True
            warnings.warn(
                f"StatsCollector pool overflowed (capacity "
                f"{self.spec.cap}): S ∪ Z may be truncated and estimate "
                f"cv is no longer guaranteed — raise TelemetryConfig."
                f"capacity or lower the per-objective k",
                RuntimeWarning, stacklevel=3)

    def size(self) -> int:
        return int(self.state.member.sum().item())

    def stats(self) -> dict:
        """Resident-footprint gauges under the serving tier's
        ``merge_stats`` wire names: the collector is a single
        always-compacted slab, so bytes are a spec constant and
        live_shards is 1 by construction."""
        return {
            "bytes_resident": multisketch_slab_bytes(self.spec),
            "live_shards": 1,
            "gc_merges": 0,
            "live_keys": self.size(),
            "multisketch_overflow": self.overflow,
        }

    @property
    def sketch(self) -> MultiSketch:
        """The wire-format state (e.g. for a cross-host gather or a
        checkpoint)."""
        return self.state


def collect_host_gauges(pool) -> dict:
    """Scale-out telemetry rows for a ``launch.pool.ShardedEnginePool``:
    per-host residency/health gauges under the same ``merge_stats`` wire
    names as ``StatsCollector.stats`` and the stream stats, plus group
    totals.

    Returns ``{"hosts": {host_id: row}, "totals": row}`` where each row
    carries ``live_shards`` / ``bytes_resident`` / ``gc_merges`` summed
    over the host's resident engines and the scale-out extras (``alive``,
    ``owned_shards``, ``replica_streams``). Totals count LIVE hosts only —
    a dead host's residency is gone. Host-side gauges throughout: no
    device sync."""
    hosts = pool.host_stats()
    totals = {"hosts": len(hosts),
              "hosts_alive": sum(1 for r in hosts.values() if r["alive"]),
              "live_shards": 0, "bytes_resident": 0, "gc_merges": 0,
              "owned_shards": 0, "replica_streams": 0}
    for row in hosts.values():
        if not row["alive"]:
            continue
        for k in ("live_shards", "bytes_resident", "gc_merges",
                  "owned_shards", "replica_streams"):
            totals[k] += row[k]
    return {"hosts": hosts, "totals": totals}
