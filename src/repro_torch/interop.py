"""Carry slab state between the JAX package and the port.

A reference ``MultiSketch`` is 8 arrays in a fixed field order (keys,
weights, probs, seeds, member, aux, valid, taus). ``from_arrays`` turns
those arrays (numpy, or anything ``np.asarray`` accepts) into the port's
``MultiSketch`` on a device; ``to_arrays`` gives the 8 fields back as
numpy arrays, from which the reference rebuilds its own slab.

A reference ``Sketch`` (the universal monotone sample's wire format) is 5
arrays (keys, weights, probs, member, valid) plus its k and hash seed:
``sketch_from_arrays`` / ``sketch_to_arrays`` carry it the same way.

A reference ``ClusterReplica`` (the hand-off unit of ``ClusterEngine``)
travels the same way: ``cluster_replica_from_arrays`` takes its sketch
fields, coords, anchor coords, eps, norm, next_key, epoch and config and
gives the port's ``ClusterReplica`` (promote it with
``ClusterEngine.from_handoff``); ``cluster_replica_to_arrays`` gives the
port's back as a dict of numpy arrays and plain values. All are exact
copies. This module imports nothing of the JAX package: the caller
converts the reference's arrays to numpy first.

Model parameters travel as the reference's nested dict of arrays (the
``params`` tree of ``repro.models.model.init_model``):
``model_params_from_arrays`` gives the port's tree of tensors on a device,
``model_params_to_arrays`` the nested dict of numpy arrays back, both
exact copies.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.core.merge import Sketch
from repro_torch.core.multi_sketch import MultiSketch
from repro_torch.launch.cluster import ClusterReplica

_DTYPES = {"keys": np.int32, "weights": np.float32, "probs": np.float32,
           "seeds": np.float32, "member": np.bool_, "aux": np.bool_,
           "valid": np.bool_, "taus": np.float32}


def from_arrays(fields: Sequence, device=None) -> MultiSketch:
    """8 slab fields (reference order) -> the port's MultiSketch."""
    if len(fields) != len(MultiSketch._fields):
        raise ValueError(f"expected {len(MultiSketch._fields)} fields, "
                         f"got {len(fields)}")
    dev = resolve_device(device)
    return MultiSketch(*(
        torch.from_numpy(np.array(x, dtype=_DTYPES[name])).to(dev)
        for name, x in zip(MultiSketch._fields, fields)))


def to_arrays(sk: MultiSketch) -> tuple:
    """The port's MultiSketch -> its 8 fields as numpy arrays."""
    return tuple(x.detach().cpu().numpy().astype(_DTYPES[name], copy=True)
                 for name, x in zip(MultiSketch._fields, sk))


def sketch_from_arrays(fields: Sequence, device=None) -> Sketch:
    """(keys, weights, probs, member, valid, k, seed) -> the port's
    Sketch on a device."""
    if len(fields) != len(Sketch._fields):
        raise ValueError(f"expected {len(Sketch._fields)} fields, "
                         f"got {len(fields)}")
    dev = resolve_device(device)
    arrays = (torch.from_numpy(np.array(x, dtype=_DTYPES[name])).to(dev)
              for name, x in zip(Sketch._fields[:5], fields))
    return Sketch(*arrays, k=int(fields[5]), seed=int(fields[6]))


def sketch_to_arrays(sk: Sketch) -> tuple:
    """The port's Sketch -> (keys, weights, probs, member, valid) as numpy
    arrays, then k and seed."""
    return tuple(x.detach().cpu().numpy().astype(_DTYPES[name], copy=True)
                 for name, x in zip(Sketch._fields[:5], sk)) + (sk.k,
                                                                 sk.seed)


def _f32(x, dev):
    return (None if x is None else torch.from_numpy(
        np.array(x, dtype=np.float32)).to(dev))


def cluster_replica_from_arrays(sketch: Sequence, coords, anchor_coords,
                                eps, norm, next_key: int, epoch: int,
                                config: dict, device=None) -> ClusterReplica:
    """A reference ClusterReplica's parts (numpy) -> the port's replica on
    a device. ``anchor_coords``, ``eps`` and ``norm`` are None before the
    source engine's first absorb."""
    dev = resolve_device(device)
    return ClusterReplica(
        sketch=from_arrays(sketch, device=dev), coords=_f32(coords, dev),
        anchor_coords=_f32(anchor_coords, dev), eps=_f32(eps, dev),
        norm=_f32(norm, dev), next_key=int(next_key), epoch=int(epoch),
        config=dict(config))


def cluster_replica_to_arrays(replica: ClusterReplica) -> dict:
    """The port's ClusterReplica -> {"sketch": 8 numpy fields, "coords",
    "anchor_coords", "eps", "norm": numpy or None, "next_key", "epoch",
    "config"}, the parts the reference's ClusterReplica is made of."""
    def arr(x):
        return (None if x is None
                else x.detach().cpu().numpy().astype(np.float32, copy=True))
    return {"sketch": to_arrays(replica.sketch),
            "coords": arr(replica.coords),
            "anchor_coords": arr(replica.anchor_coords),
            "eps": arr(replica.eps), "norm": arr(replica.norm),
            "next_key": int(replica.next_key), "epoch": int(replica.epoch),
            "config": dict(replica.config)}


def model_params_from_arrays(cfg, tree, device=None) -> dict:
    """The reference's nested dict of parameter arrays -> the port's tree
    of tensors on a device, checked leaf by leaf against the shapes of
    ``init_model(cfg)``."""
    from repro_torch.models.model import abstract_params
    dev = resolve_device(device)
    want = dict(T.flatten(abstract_params(cfg)[0]))
    got = dict(T.flatten(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter paths differ: extra "
                         f"{sorted(set(got) - set(want))}, missing "
                         f"{sorted(set(want) - set(got))}")
    out = []
    for path, leaf in got.items():
        a = np.array(leaf, dtype=np.float32)
        if a.shape != tuple(want[path].shape):
            raise ValueError(f"{path}: shape {a.shape}, want "
                             f"{tuple(want[path].shape)}")
        out.append((path, torch.from_numpy(a).to(dev)))
    return T.unflatten(out)


def model_params_to_arrays(params) -> dict:
    """The port's parameter tree -> the nested dict of numpy arrays the
    reference's functions take."""
    return T.unflatten(
        (path, leaf.detach().cpu().numpy().copy())
        for path, leaf in T.flatten(params))
