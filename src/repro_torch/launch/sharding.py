"""Logical-axis -> mesh-axis mapping (partition rules).

Port of ``repro/launch/sharding.py``. Model code declares per-dimension
LOGICAL axes ("embed", "q_heads", "mlp", "vocab", ...); this module maps
them to mesh axes with divisibility gating, as tuples of axis names equal
to the reference's ``PartitionSpec``s. A dimension is sharded on "model"
only when its size divides evenly. The port runs at a ``model`` axis of 1
(``launch/mesh.py``), so these specs describe placements; the only
placement it carries out is the batch split over (pod, data)
(``batch_slice``). ``cache_pspecs`` is the reference's ``cache_shardings``
rule for decode caches.
"""
from __future__ import annotations

from repro_torch import tree as T

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


def batch_slice(mesh, n: int) -> slice:
    """The rows of an n-row global batch this rank holds: the batch is
    split over (pod, data) in row-major order, as ``batch_pspec`` says."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    parts, index = 1, 0
    for a in axes:
        parts *= mesh.shape[a]
        index = index * mesh.shape[a] + mesh.coords[a]
    if n % parts:
        raise ValueError(f"global batch {n} does not split over {parts} "
                         f"(pod, data) ranks")
    b = n // parts
    return slice(index * b, (index + 1) * b)
