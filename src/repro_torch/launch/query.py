"""Device-resident segment-query engine (the serving tier).

Port of ``repro/launch/query.py`` ``SegmentQueryEngine``:

  * per-shard ``MultiSketch`` slabs stay resident on the device; absorbing
    a chunk folds it into its shard's slab;
  * the merged slab is maintained AT ABSORB TIME (the default): the
    post-fold shard slab is folded into the cached merged slab in the same
    epoch, so queries under churn pay zero merge work. A cold or stale
    cache (first query, restore, non-monotone mutation) falls back to the
    lazy ladder at query time: cache hit -> incremental fold of the dirty
    shards -> full stacked re-merge;
  * ``gc`` merges cold shards into the base slab (shard 0) and parks them
    on one shared inert slab; ``spill`` persists victims first;
  * ``query_many`` answers B predicates x |F| objectives with one K4
    launch over the merged slab.

Every fold returns fresh tensors (no buffer donation), so a slab handed
out through ``merged`` or ``shard_slab`` stays valid across later folds.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.funcs import StatFn
from repro_torch.core.multi_sketch import (MultiSketch, MultiSketchSpec,
                                           multisketch_absorb,
                                           multisketch_absorb_slabs,
                                           multisketch_empty,
                                           multisketch_overflow,
                                           multisketch_query_many, pad_chunk,
                                           spec_from_meta, spec_to_meta)
from repro_torch.core.predicates import EVERYTHING, SegmentPredicate


def _full_remerge(shards, *, spec, use_kernels):
    """Full re-merge as a stacked delta fold into a fresh empty slab: the
    same fold as the incremental and absorb-time paths."""
    dk = torch.stack([s.keys for s in shards])
    dw = torch.stack([s.weights for s in shards])
    dv = torch.stack([s.valid for s in shards])
    empty = multisketch_empty(spec, device=shards[0].keys.device)
    return multisketch_absorb_slabs(empty, dk, dw, dv, spec=spec,
                                    use_kernels=use_kernels)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SegmentQueryEngine:
    """Resident per-shard MultiSketches + merged-slab upkeep + batched
    queries. ``device=None`` is the CUDA card (raises without one);
    ``device="cpu"`` runs the plain PyTorch versions of the kernels."""

    def __init__(self, spec: MultiSketchSpec, shards: int = 1,
                 b_quantum: int = 16, chunk: int = 256,
                 use_kernels: Optional[bool] = None,
                 max_delta: Optional[int] = None,
                 absorb_time: bool = True,
                 gc_max_live: Optional[int] = None,
                 device=None):
        if shards < 1:
            raise ValueError(f"need >= 1 shard, got {shards}")
        self.device = resolve_device(device)
        self.spec = spec
        self.b_quantum = int(b_quantum)
        self.chunk = int(chunk)
        self.use_kernels = use_kernels
        # fold at most this many dirty shards into the cached merged slab
        # before a full re-merge (None -> any strict subset of the shards)
        self.max_delta = max_delta
        self.absorb_time = bool(absorb_time)
        # auto-GC water-mark on the live shard count (None -> manual gc)
        self.gc_max_live = (None if gc_max_live is None
                            else max(int(gc_max_live), 1))
        # one shared inert slab backs never-touched and GC'd shards
        self._empty = multisketch_empty(spec, device=self.device)
        self._shards = [self._empty for _ in range(shards)]
        self._min_shards = shards  # construction layout: never truncated
        self._epoch = 0            # bumped by every state mutation
        self.last_gc_epoch = -1
        self._merged: Optional[MultiSketch] = None
        self._merged_epoch = -1    # epoch the cached merged slab reflects
        self._overflow_epoch = -1  # epoch merge_stats["overflow"] reflects
        # _shard_epochs[i]: epoch of shard i's last mutation; _merged_base:
        # the _shard_epochs snapshot the cache reflects (None after a
        # non-monotone mutation: only a full re-merge is exact then)
        self._shard_epochs = [0] * shards
        self._shard_live = [False] * shards
        self._merged_base: Optional[list] = None
        self.merge_stats = {"full": 0, "incremental": 0, "hit": 0,
                            "absorb_time": 0, "gc_merges": 0,
                            "live_shards": 0, "bytes_resident": 0,
                            "overflow": False}
        self._update_gauges()

    # -- resident state ----------------------------------------------------
    @property
    def num_shards(self) -> int:
        return len(self._shards)

    @property
    def epoch(self) -> int:
        return self._epoch

    def _maintain_eligible(self) -> bool:
        """Absorb-time upkeep needs a CURRENT cache from a monotone history
        at a non-truncating capacity (where delta == full bit for bit)."""
        return (self.absorb_time and self._merged is not None
                and self._merged_epoch == self._epoch
                and self._merged_base is not None
                and self.spec.cap >= self.spec.default_capacity())

    def absorb(self, keys, weights, active=None, shard: int = 0):
        """Fold a chunk into one shard's slab; with ``absorb_time`` then
        fold the post-fold shard slab into the cached merged slab (the
        computation the lazy ladder would run at the next query, so the
        bits are the same)."""
        if not 0 <= shard < len(self._shards):
            raise IndexError(f"shard {shard} out of range "
                             f"({len(self._shards)} shards)")
        maintain = self._maintain_eligible()
        # single-shard fast path: when the cache IS the target shard, the
        # shard fold is the merged-slab fold
        realias = maintain and self._merged is self._shards[shard]
        keys, weights, active = pad_chunk(keys, weights, active, self.chunk)
        self._shards[shard] = multisketch_absorb(
            self._shards[shard], keys, weights, active, spec=self.spec,
            use_kernels=self.use_kernels)
        self._epoch += 1
        self._shard_epochs[shard] = self._epoch
        self._shard_live[shard] = True
        if realias:
            self._merged = self._shards[shard]
            self._stamp_absorb_time()
        elif maintain:
            d = self._shards[shard]
            self._merged = multisketch_absorb_slabs(
                self._merged, d.keys, d.weights, d.valid, spec=self.spec,
                use_kernels=self.use_kernels)
            self._stamp_absorb_time()
        self._maybe_auto_gc()
        self._update_gauges()

    def drain(self) -> None:
        """Block until the device has finished every fold behind the
        current state, and read the saturation flag while the host waits
        anyway, so the epoch's first query pays for neither."""
        _sync(self.device)
        if self._merged is not None and self._merged_epoch == self._epoch:
            self._refresh_overflow(self._merged)

    def _stamp_absorb_time(self):
        self._merged_epoch = self._epoch
        self._merged_base = list(self._shard_epochs)
        self.merge_stats["absorb_time"] += 1

    def set_shard(self, shard: int, sketch: MultiSketch):
        """Install a prebuilt slab (copied in) as one shard. Non-monotone:
        the cached merged slab is dropped (full re-merge next)."""
        self._shards[shard] = MultiSketch(
            *(x.to(self.device, copy=True) for x in sketch))
        self._epoch += 1
        self._shard_epochs[shard] = self._epoch
        self._shard_live[shard] = True
        self._drop_merged_cache()
        self._update_gauges()

    def shard_slab(self, shard: int) -> MultiSketch:
        """Shard ``shard``'s resident slab (by reference; folds never write
        into it)."""
        return self._shards[shard]

    def shard_live(self, shard: int) -> bool:
        return bool(self._shard_live[shard])

    def clear_shard(self, shard: int):
        """Park one shard on the shared inert slab. Non-monotone: the
        cached merged slab is dropped."""
        self._shards[shard] = self._empty
        self._epoch += 1
        self._shard_epochs[shard] = self._epoch
        self._shard_live[shard] = False
        self._drop_merged_cache()
        self._update_gauges()

    def add_shard(self, sketch: MultiSketch):
        """Append a prebuilt slab (copied in) as a NEW shard. Adds data
        only: a current cache absorbs it in this epoch under
        ``absorb_time``; otherwise the next query folds just this slab."""
        maintain = self._maintain_eligible()
        sk = MultiSketch(*(x.to(self.device, copy=True) for x in sketch))
        self._shards.append(sk)
        self._epoch += 1
        self._shard_epochs.append(self._epoch)
        self._shard_live.append(True)
        if maintain:
            self._merged = multisketch_absorb_slabs(
                self._merged, sk.keys, sk.weights, sk.valid, spec=self.spec,
                use_kernels=self.use_kernels)
            self._stamp_absorb_time()
        self._maybe_auto_gc()
        self._update_gauges()

    def load_stacked(self, stacked: MultiSketch):
        """Adopt a stacked batch of per-shard slabs (leaves [m, ...]) as
        the resident state, copied to the engine's device; the merge stays
        lazy until the first query. Wholesale replacement: the merged-slab
        cache is dropped (full path next) and the adopted layout becomes
        the new un-truncatable base layout."""
        m = stacked.keys.shape[0]
        self._shards = [MultiSketch(*(x[i].to(self.device, copy=True)
                                      for x in stacked)) for i in range(m)]
        self._min_shards = m
        self._epoch += 1
        self._shard_epochs = [self._epoch] * m
        self._shard_live = [True] * m
        self._drop_merged_cache()
        self._update_gauges()

    @classmethod
    def from_sharded(cls, spec: MultiSketchSpec, mesh, keys, weights,
                     active=None, axis: str = "data", **kw
                     ) -> "SegmentQueryEngine":
        """Build per-rank slabs over data split along a mesh axis (local
        selection only, no merge: ``launch.summary.
        sharded_multisketch_shards``) and hold them resident, one shard
        per rank. ``device`` defaults to the mesh's."""
        from repro_torch.launch.summary import sharded_multisketch_shards
        stacked = sharded_multisketch_shards(spec, mesh, keys, weights,
                                             active, axis=axis,
                                             use_kernels=kw.get(
                                                 "use_kernels"))
        kw.setdefault("device", mesh.device)
        eng = cls(spec, shards=stacked.keys.shape[0], **kw)
        eng.load_stacked(stacked)
        return eng

    def _drop_merged_cache(self):
        self._merged = None
        self._merged_epoch = -1
        self._merged_base = None

    def _update_gauges(self):
        """Live shard count and device bytes resident (shared tensors, such
        as the inert slab and the single-shard merged alias, counted
        once)."""
        self.merge_stats["live_shards"] = int(sum(self._shard_live))
        seen: set = set()
        total = 0
        slabs = list(self._shards) + [self._empty]
        if self._merged is not None:
            slabs.append(self._merged)
        for sk in slabs:
            for leaf in sk:
                if id(leaf) not in seen:
                    seen.add(id(leaf))
                    total += leaf.nelement() * leaf.element_size()
        self.merge_stats["bytes_resident"] = total

    # -- shard lifecycle (GC / spill) ---------------------------------------
    def _maybe_auto_gc(self):
        if (self.gc_max_live is not None
                and sum(self._shard_live) > self.gc_max_live):
            self.gc(max_live=self.gc_max_live)

    def gc_plan(self, max_live: Optional[int] = None,
                min_age: Optional[int] = None) -> list:
        """Victim shard indices a ``gc`` with these water-marks would merge
        into the base slab, oldest (by last-absorb epoch) first. Pure."""
        if max_live is None and min_age is None:
            max_live = self.gc_max_live
        if len(self._shards) <= 1:
            return []
        cand = sorted((i for i in range(1, len(self._shards))
                       if self._shard_live[i]),
                      key=lambda i: (self._shard_epochs[i], i))
        vict: set = set()
        if min_age is not None:
            vict = {i for i in cand
                    if self._epoch - self._shard_epochs[i] >= int(min_age)}
        if max_live is not None:
            target = max(int(max_live), 1)
            n_live = len(cand) + (1 if self._shard_live[0] else 0)
            for i in cand:
                if n_live - len(vict) <= target:
                    break
                vict.add(i)
        return sorted(vict)

    def gc(self, max_live: Optional[int] = None,
           min_age: Optional[int] = None,
           spill_dir: Optional[str] = None) -> list:
        """Merge cold shards into the base slab (shard 0); returns the
        victims. The union, hence every answer, is unchanged."""
        return self.gc_apply(self.gc_plan(max_live, min_age),
                             spill_dir=spill_dir)

    def gc_apply(self, victims, spill_dir: Optional[str] = None) -> list:
        """Apply a GC merge to an explicit victim list (``gc_plan`` output
        or a WAL-replayed directive)."""
        victims = sorted({int(i) for i in victims})
        if not victims:
            return []
        if victims[0] < 1 or victims[-1] >= len(self._shards):
            raise ValueError(f"gc victims {victims} out of range "
                             f"(1..{len(self._shards) - 1})")
        # a GC merge never changes the union: a current cache stays current
        cache_current = (self._merged is not None
                         and self._merged_epoch == self._epoch
                         and self._merged_base is not None)
        if spill_dir is not None:
            self.spill(spill_dir, victims)
        if len(victims) == 1:
            d = self._shards[victims[0]]
            dk, dw, dv = d.keys, d.weights, d.valid
        else:
            dk = torch.stack([self._shards[i].keys for i in victims])
            dw = torch.stack([self._shards[i].weights for i in victims])
            dv = torch.stack([self._shards[i].valid for i in victims])
        self._shards[0] = multisketch_absorb_slabs(
            self._shards[0], dk, dw, dv, spec=self.spec,
            use_kernels=self.use_kernels)
        for i in victims:
            self._shards[i] = self._empty
            self._shard_live[i] = False
        self._epoch += 1
        self._shard_epochs[0] = self._epoch
        self._shard_live[0] = True
        for i in victims:
            self._shard_epochs[i] = self._epoch
        while (len(self._shards) > max(self._min_shards, 1)
               and not self._shard_live[-1]
               and self._shards[-1] is self._empty):
            self._shards.pop()
            self._shard_epochs.pop()
            self._shard_live.pop()
        self.merge_stats["gc_merges"] += 1
        self.last_gc_epoch = self._epoch
        if cache_current:
            self._merged_epoch = self._epoch
            self._merged_base = list(self._shard_epochs)
        self._update_gauges()
        return victims

    def spill(self, directory: str, shards) -> int:
        """Persist the given shards' slabs through the checkpoint manager;
        the step restores with ``from_checkpoint``."""
        from repro_torch.ckpt.manager import CheckpointManager
        shards = [int(i) for i in shards]
        mgr = CheckpointManager(directory)
        step = max(mgr.list_steps(), default=-1) + 1
        mgr.save(step, {"shards": [self._shards[i] for i in shards]},
                 extra_meta={"multisketch_spec": spec_to_meta(self.spec),
                             "num_shards": len(shards),
                             "spilled_from": shards,
                             "spill_epoch": self._epoch})
        return step

    # -- checkpointing -----------------------------------------------------
    def save_checkpoint(self, directory: str, step: Optional[int] = None,
                        blocking: bool = True,
                        extra_meta: Optional[dict] = None):
        """Persist the per-shard slabs + the spec through the checkpoint
        manager, in the reference's layout and metadata. ``step`` defaults
        to one past the newest existing step."""
        from repro_torch.ckpt.manager import CheckpointManager
        mgr = CheckpointManager(directory)
        if step is None:
            step = max(mgr.list_steps(), default=-1) + 1
        ex = dict(extra_meta or {})
        ex.update({"multisketch_spec": spec_to_meta(self.spec),
                   "num_shards": len(self._shards),
                   "b_quantum": self.b_quantum,
                   "chunk": self.chunk,
                   "max_delta": self.max_delta,
                   "shard_live": [bool(x) for x in self._shard_live],
                   "min_shards": self._min_shards,
                   "gc_max_live": self.gc_max_live,
                   "absorb_time": self.absorb_time})
        mgr.save(step, {"shards": list(self._shards)}, blocking=blocking,
                 extra_meta=ex)
        return mgr

    @classmethod
    def from_checkpoint(cls, directory: str,
                        use_kernels: Optional[bool] = None,
                        return_meta: bool = False, device=None):
        """Rebuild an engine from the newest intact checkpoint (spec and
        slabs from the SAME step, falling back step by step past corrupt
        ones). ``return_meta=True`` -> ``(engine, extra)``."""
        from repro_torch.ckpt.manager import CheckpointManager
        dev = resolve_device(device)
        mgr = CheckpointManager(directory)
        for step in reversed(mgr.list_steps()):
            try:
                _, meta = mgr.read_meta(step)
                ex = meta["extra"]
                spec = spec_from_meta(ex["multisketch_spec"])
                num_shards = int(ex["num_shards"])
            except (FileNotFoundError, KeyError, ValueError, TypeError):
                continue
            template = {"shards": [multisketch_empty(spec, device=dev)
                                   for _ in range(num_shards)]}
            state = mgr.restore_step(step, template)
            if state is None:
                continue
            md = ex.get("max_delta")
            gml = ex.get("gc_max_live")
            eng = cls(spec, shards=num_shards,
                      b_quantum=int(ex.get("b_quantum", 16)),
                      chunk=int(ex.get("chunk", 256)),
                      use_kernels=use_kernels,
                      max_delta=None if md is None else int(md),
                      absorb_time=bool(ex.get("absorb_time", True)),
                      gc_max_live=None if gml is None else int(gml),
                      device=dev)
            eng._shards = list(state["shards"])
            eng._epoch += 1
            eng._shard_epochs = [eng._epoch] * num_shards
            live = ex.get("shard_live")
            eng._shard_live = ([bool(x) for x in live]
                               if live is not None and len(live) == num_shards
                               else [True] * num_shards)
            eng._min_shards = int(ex.get("min_shards", num_shards))
            eng._update_gauges()
            return (eng, ex) if return_meta else eng
        raise FileNotFoundError(
            f"no intact checkpoint restorable under {directory}")

    # -- lazy merge-on-demand ----------------------------------------------
    def _dirty_shards(self) -> Optional[list]:
        """Shards mutated since the cached merge, or None when the cache
        cannot seed an incremental fold."""
        if (self._merged is None or self._merged_base is None
                or self.spec.cap < self.spec.default_capacity()):
            return None
        base = self._merged_base
        return [i for i in range(len(self._shards))
                if i >= len(base) or self._shard_epochs[i] > base[i]]

    def _incremental_eligible(self, dirty: Optional[list]) -> bool:
        if not dirty:
            return False
        limit = (len(self._shards) - 1 if self.max_delta is None
                 else self.max_delta)
        return len(dirty) <= max(limit, 0)

    def _materialize_merged(self) -> MultiSketch:
        """The merged slab, maintained at most once per epoch: a cache hit,
        an incremental fold of the dirty shards, or the full re-merge."""
        if self._merged_epoch == self._epoch:
            self.merge_stats["hit"] += 1
            return self._refresh_overflow(self._merged)
        dirty = self._dirty_shards()
        if self._incremental_eligible(dirty):
            if len(dirty) == 1:
                d = self._shards[dirty[0]]
                dk, dw, dv = d.keys, d.weights, d.valid
            else:
                dk = torch.stack([self._shards[i].keys for i in dirty])
                dw = torch.stack([self._shards[i].weights for i in dirty])
                dv = torch.stack([self._shards[i].valid for i in dirty])
            self._merged = multisketch_absorb_slabs(
                self._merged, dk, dw, dv, spec=self.spec,
                use_kernels=self.use_kernels)
            self.merge_stats["incremental"] += 1
        elif len(self._shards) == 1:
            self._merged = self._shards[0]
            self.merge_stats["full"] += 1
        else:
            self._merged = _full_remerge(
                self._shards, spec=self.spec, use_kernels=self.use_kernels)
            self.merge_stats["full"] += 1
        self._merged_epoch = self._epoch
        self._merged_base = list(self._shard_epochs)
        return self._refresh_overflow(self._merged)

    def _refresh_overflow(self, sk: MultiSketch) -> MultiSketch:
        """Read the saturation flag (a device -> host read) at most once
        per epoch."""
        if self._overflow_epoch != self._epoch:
            self.merge_stats["overflow"] = bool(multisketch_overflow(sk))
            self._overflow_epoch = self._epoch
        return sk

    @property
    def merged(self) -> MultiSketch:
        """The merged slab, materialized at most once per epoch; the
        handle stays valid across later folds."""
        return self._materialize_merged()

    # -- queries -----------------------------------------------------------
    def query_many(self, fs: Optional[Sequence[StatFn]] = None,
                   predicates=EVERYTHING) -> np.ndarray:
        """Q(f_i, H_b) for every objective x predicate -> float [|F|, B],
        one K4 launch over the merged slab; B padded to ``b_quantum``."""
        fs = (tuple(f for f, _ in self.spec.objectives) if fs is None
              else tuple(fs))
        return multisketch_query_many(self._materialize_merged(), fs,
                                      predicates, b_quantum=self.b_quantum,
                                      use_kernels=self.use_kernels)

    def query(self, f: StatFn, predicate: SegmentPredicate = EVERYTHING
              ) -> float:
        """Single Q(f, H), through the batched path."""
        return float(self.query_many((f,), predicate)[0, 0])
