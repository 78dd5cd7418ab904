"""Logical-axis -> mesh-axis mapping (partition rules).

Port of ``repro/launch/sharding.py``. Model code declares per-dimension
LOGICAL axes ("embed", "q_heads", "mlp", "vocab", ...); this module maps
them to mesh axes with divisibility gating, as tuples of axis names equal
to the reference's ``PartitionSpec``s. A dimension is sharded on "model"
only when its size divides evenly. ``cache_pspecs`` is the reference's
``cache_shardings`` rule for decode caches.

The placement is explicit: there is no GSPMD. ``place`` cuts every leaf to
the block this rank holds (each named mesh axis splits its dim into equal
blocks, taken at this rank's coordinate; a tuple of axes splits it in
row-major order), ``unplace`` gathers the blocks back into the whole leaf
on every rank, and the model code (``models/parallel.py``) calls the
collectives by name. ``param_shardings`` / ``batch_shardings`` /
``cache_shardings`` / ``replicated`` keep the reference's names and give
``NamedSharding``s: a pspec bound to its mesh.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.launch.mesh import all_gather_dim

# logical axes that map to the tensor-parallel ("model") mesh axis
_MODEL_AXES = ("q_heads", "kv_heads", "mlp", "vocab", "expert", "inner")


def map_spec_tree(fn, spec_tree):
    """``fn`` over the spec tuples of a nested-dict spec tree."""
    return T.tree_map(fn, spec_tree)


def logical_to_pspec(spec: tuple, shape: tuple, mesh,
                     fsdp: bool = False) -> tuple:
    """One param's logical spec + shape -> its partition spec on this mesh
    (a tuple of mesh axis names / None, trailing Nones stripped).

    fsdp=True additionally shards the largest remaining divisible named
    dim over "data"."""
    msize = mesh.shape["model"]
    axes = []
    used = False  # at most one dim per mesh axis; first eligible wins
    for dim, name in zip(shape, spec):
        if not used and name in _MODEL_AXES and dim % msize == 0:
            axes.append("model")
            used = True
        else:
            axes.append(None)
    if fsdp and "data" in mesh.axis_names:
        dsize = mesh.shape["data"]
        named = list(spec) + [None] * (len(shape) - len(spec))
        # only NAMED dims are fsdp-eligible: the anonymous leading dim of
        # stacked layer params is looped over and stays unsharded
        cand = sorted(((d, i) for i, d in enumerate(shape)
                       if axes[i] is None and named[i] is not None
                       and d % dsize == 0 and d >= dsize),
                      reverse=True)
        if cand:
            axes[cand[0][1]] = "data"
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def param_pspecs(spec_tree, shape_tree, mesh, fsdp: bool = False):
    """The partition-spec tree of the params (and, reused, of the
    optimizer moments)."""
    return T.tree_map(lambda spec, shaped: logical_to_pspec(
        tuple(spec), tuple(shaped.shape), mesh, fsdp), spec_tree, shape_tree)


def batch_pspec(mesh) -> tuple:
    """Global-batch sharding over (pod?, data)."""
    if "pod" in mesh.axis_names:
        return (("pod", "data"),)
    return ("data",)


def _nshards(mesh, axes) -> int:
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh.shape[a]
    return n


def cache_pspecs(cache_tree, cfg, mesh):
    """Decode caches: the batch dim (dim 1; the stacked layers lead) on
    (pod?, data), the LARGEST divisible remaining dim on "model" (seq for
    kv caches: sequence-parallel decode attention; channels for SSM
    states). Layouts, nested trees included:
      dense kv:   [L, B, S, K, hd]   -> (None, batch, model?)
      hybrid kv:  [G, B, S, K, hd]   -> same
      mamba conv: [L, B, K-1, C]     -> (None, batch, None, model?)
      mamba h:    [L, B, di, N] / [L, B, H, hd, N]"""
    b = batch_pspec(mesh)[0]
    nb = _nshards(mesh, b)
    msize = mesh.shape["model"]

    def one(leaf):
        dims = list(leaf.shape)
        axes = [None] * len(dims)
        if len(dims) >= 2 and dims[1] % nb == 0:
            axes[1] = b
        cand = sorted(((d, i) for i, d in enumerate(dims[2:], start=2)),
                      reverse=True)
        for d, i in cand:
            if d % msize == 0 and d >= msize:
                axes[i] = "model"
                break
        while axes and axes[-1] is None:
            axes.pop()
        return tuple(axes)
    return T.tree_map(one, cache_tree)


def _batch_split(mesh, axes) -> tuple:
    """(number of ranks, this rank's index) over the mesh's ``axes`` among
    (pod, data), row-major."""
    parts, index = 1, 0
    for a in axes:
        if a in mesh.axis_names:
            parts *= mesh.shape[a]
            index = index * mesh.shape[a] + mesh.coords[a]
    return parts, index


def batch_slice(mesh, n: int, axes=("pod", "data")) -> slice:
    """The rows of an n-row global batch this rank holds: the batch is
    split over ``axes`` (default (pod, data)) in row-major order, as
    ``batch_pspec`` says. Raises when n does not split evenly."""
    parts, index = _batch_split(mesh, axes)
    if n % parts:
        raise ValueError(f"global batch {n} does not split over {parts} "
                         f"({', '.join(axes)}) ranks")
    b = n // parts
    return slice(index * b, (index + 1) * b)


def batch_share(mesh, n: int, axes=("pod", "data")) -> tuple:
    """This rank's share of an n-row batch axis constrained over ``axes``
    (row-major), as GSPMD lays out an axis that need not divide: shares
    of ceil(n / ranks) rows, the last ranks' short or empty. Returns (the
    rows the rank holds, the share's full size)."""
    parts, index = _batch_split(mesh, axes)
    size = -(-n // parts)
    lo = min(index * size, n)
    return slice(lo, min(lo + size, n)), size


# ---------------------------------------------------------------------------
# pspecs bound to a mesh, and the placement they describe
# ---------------------------------------------------------------------------

class NamedSharding:
    """A partition spec bound to its mesh (the reference's
    ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec: tuple = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"NamedSharding({self.spec})"


def bind(mesh, pspec_tree):
    """A pspec tree -> the ``NamedSharding`` tree on ``mesh``."""
    return T.tree_map(lambda sp: NamedSharding(mesh, sp), pspec_tree)


def param_shardings(spec_tree, shape_tree, mesh, fsdp: bool = False):
    """The ``NamedSharding`` tree of the params (and, reused, of the
    moments)."""
    return bind(mesh, param_pspecs(spec_tree, shape_tree, mesh, fsdp))


def batch_shardings(batch_tree, mesh):
    """Every batch leaf on its leading (batch) dim, replicated when the
    batch does not split over the (pod, data) ranks."""
    b = batch_pspec(mesh)[0]
    n = _nshards(mesh, b)
    return T.tree_map(lambda leaf: NamedSharding(
        mesh, (b,) if leaf.shape[0] % n == 0 else ()), batch_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def cache_shardings(cache_tree, cfg, mesh):
    """``cache_pspecs`` bound to the mesh."""
    return bind(mesh, cache_pspecs(cache_tree, cfg, mesh))


def _split(mesh, axes) -> tuple:
    """(number of blocks, this rank's block index) of a dim placed on
    ``axes`` (one name or a tuple, row-major)."""
    n, i = 1, 0
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh.shape[a]
        i = i * mesh.shape[a] + mesh.coords[a]
    return n, i


def block_of(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf ``x`` under ``spec``, contiguous
    (a copy unless nothing is split: a block that is a contiguous slice,
    as one row's, would otherwise be a view that keeps the whole alive)."""
    whole = x
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n, i = _split(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n} blocks ({axes})")
        size = x.shape[dim] // n
        x = x.narrow(dim, i * size, size)
    if x.shape == whole.shape:
        return x.contiguous()
    return x.clone(memory_format=torch.contiguous_format)


def whole_of(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block ``x``: every placed dim
    gathered over its axes (a collective over them)."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for a in reversed(axes if isinstance(axes, tuple) else (axes,)):
            x = all_gather_dim(mesh, a, x.contiguous(), dim)
    return x


def _map_placed(fn, tree, pspecs):
    """``fn(leaf, spec)`` over a state tree and its pspec (or
    NamedSharding) tree, whose NamedTuple nodes (the telemetry slab) carry
    one spec per field."""
    if isinstance(tree, dict):
        return {k: _map_placed(fn, v, pspecs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_placed(fn, v, s)
                            for v, s in zip(tree, pspecs)))
    return fn(tree, pspecs.spec if isinstance(pspecs, NamedSharding)
              else pspecs)


def place(tree, pspecs, mesh):
    """The whole leaves of ``tree`` -> the blocks this rank holds under
    ``pspecs`` (pspecs or NamedShardings, the tree's structure)."""
    return _map_placed(lambda x, s: block_of(x, s, mesh), tree, pspecs)


def unplace(tree, pspecs, mesh):
    """This rank's blocks -> the whole leaves, on every rank (every rank of
    the mesh must call it)."""
    return _map_placed(lambda x, s: whole_of(x, s, mesh), tree, pspecs)
