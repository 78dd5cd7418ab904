"""Sharded MultiSketch construction (paper §3.3 composability) over a
``torch.distributed`` mesh, and the cross-host merge of slabs.

Port of ``repro/launch/summary.py``. The distributed build of a summary
over data split along a mesh axis is three steps:

  1. local build: every rank runs the one-shot build over ITS shard only
     (``multisketch_build``: K1-K3 on the card);
  2. all_gather of the fixed-capacity slabs over the axis's group, the
     only collective;
  3. one stacked re-selection over the m * c gathered slots
     (``multisketch_merge_stacked``), exact by the threshold-closure
     invariant, so the result equals a one-shot build over the whole data.

The reference builds with ``use_kernels=False``; the port's kernel path
and plain path give identical slabs, so the port builds with its kernels.
``merge_host_slabs`` is step 3 for host-level slabs, the cross-host read
path of the scale-out pool (``launch.pool.ShardedEnginePool``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import as_1d
from repro_torch.core.multi_sketch import (MultiSketch, MultiSketchSpec,
                                           multisketch_build,
                                           multisketch_merge_stacked)
from repro_torch.launch.mesh import all_gather


def _local_build(spec, mesh, keys, weights, active, axis, use_kernels):
    """Step 1: this rank's slab over its shard of the global arrays."""
    dev = mesh.device
    keys = as_1d(keys, torch.int32, dev)
    weights = as_1d(weights, torch.float32, dev)
    active = (torch.ones(keys.shape, dtype=torch.bool, device=dev)
              if active is None else as_1d(active, torch.bool, dev))
    m = mesh.shape[axis]
    n = keys.shape[0]
    if n % m:
        raise ValueError(f"{n} rows do not split over the {m} ranks of "
                         f"axis {axis!r}")
    part = slice(mesh.coords[axis] * (n // m), (mesh.coords[axis] + 1)
                 * (n // m))
    return multisketch_build(spec, keys[part], weights[part], active[part],
                             use_kernels=use_kernels)


def _gather_slabs(mesh, axis, sk: MultiSketch) -> MultiSketch:
    """Step 2: every field stacked [m, ...] over the axis's ranks."""
    return MultiSketch(*(all_gather(mesh, axis, x) for x in sk))


def sharded_multisketch(spec: MultiSketchSpec, mesh, keys, weights,
                        active=None, axis: str = "data",
                        use_kernels: Optional[bool] = None) -> MultiSketch:
    """S^(F) ∪ Z of data split along ``axis``: local build -> all_gather
    of the slabs -> one re-selection. Exact (the member set, probs and
    taus of a one-shot build over the whole data).

    keys/weights/active are the GLOBAL arrays (the same on every rank);
    each rank builds over its contiguous part along ``axis``, so their
    length must be a multiple of the axis size. Every rank gets the merged
    slab, on ``mesh.device``."""
    sk = _local_build(spec, mesh, keys, weights, active, axis, use_kernels)
    return multisketch_merge_stacked(
        spec, _gather_slabs(mesh, axis, sk),
        use_kernels=True if use_kernels is None else use_kernels)


def sharded_multisketch_shards(spec: MultiSketchSpec, mesh, keys, weights,
                               active=None, axis: str = "data",
                               use_kernels: Optional[bool] = None
                               ) -> MultiSketch:
    """Step 1 as STACKED slabs (leaves [m, ...], one row per rank along
    ``axis``) and no re-selection: the resident state of the lazy serving
    tier (``SegmentQueryEngine.load_stacked``). Merging all m rows
    reproduces ``sharded_multisketch`` bit for bit.

    The reference returns one array sharded over the mesh; under
    multi-process torch each rank holds only its own row, so every rank
    gets the stacked slabs through one all_gather, the same bytes as step
    2 of the eager build."""
    sk = _local_build(spec, mesh, keys, weights, active, axis, use_kernels)
    return _gather_slabs(mesh, axis, sk)


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


def multisketch_shape(spec: MultiSketchSpec) -> MultiSketch:
    """A slab's shapes and dtypes as meta-device tensors (nothing
    allocated)."""
    c, nf = spec.cap, spec.nf

    def f(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return MultiSketch(
        keys=f((c,), torch.int32), weights=f((c,), torch.float32),
        probs=f((c,), torch.float32), seeds=f((nf, c), torch.float32),
        member=f((c,), torch.bool), aux=f((c,), torch.bool),
        valid=f((c,), torch.bool), taus=f((nf,), torch.float32))
