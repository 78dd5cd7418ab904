"""Cross-host merge of MultiSketch slabs (step 3 of the sharded build).

Port of ``repro/launch/summary.py`` ``merge_host_slabs``: one stacked
re-selection over already-merged per-host slabs, the cross-host read path
of the scale-out pool (``launch.pool.ShardedEnginePool``). The mesh builds
of the reference (``sharded_multisketch``, ``sharded_multisketch_shards``)
are not ported yet.

Exactness is the threshold-closure argument: each host's merged slab is
S^(F) ∪ Z of that host's shard union, and one re-selection over the
stacked host slabs recovers the sample of the global union (paper §3.3 —
composability is transitive through intermediate merges). Bit-identity
with a single-host engine over the same data holds because this routes
through the engine's own fold (``launch.query._full_remerge``: the stacked
delta fold into a fresh empty slab and the canonical fixed-shape
finalizer).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.multi_sketch import MultiSketch, MultiSketchSpec


def merge_host_slabs(spec: MultiSketchSpec, slabs,
                     use_kernels: Optional[bool] = None) -> MultiSketch:
    """One stacked re-selection over a list of per-host merged slabs; a
    single slab is returned as it is, and an empty list raises."""
    slabs = list(slabs)
    if not slabs:
        raise ValueError("merge_host_slabs needs >= 1 host slab")
    if len(slabs) == 1:
        return slabs[0]
    from repro_torch.launch.query import _full_remerge
    return _full_remerge(slabs, spec=spec, use_kernels=use_kernels)
