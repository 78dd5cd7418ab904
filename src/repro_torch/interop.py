"""Carry slab state between the JAX package and the port.

A reference ``MultiSketch`` is 8 arrays in a fixed field order (keys,
weights, probs, seeds, member, aux, valid, taus). ``from_arrays`` turns
those arrays (numpy, or anything ``np.asarray`` accepts) into the port's
``MultiSketch`` on a device; ``to_arrays`` gives the 8 fields back as
numpy arrays, from which the reference rebuilds its own slab.

A reference ``ClusterReplica`` (the hand-off unit of ``ClusterEngine``)
travels the same way: ``cluster_replica_from_arrays`` takes its sketch
fields, coords, anchor coords, eps, norm, next_key, epoch and config and
gives the port's ``ClusterReplica`` (promote it with
``ClusterEngine.from_handoff``); ``cluster_replica_to_arrays`` gives the
port's back as a dict of numpy arrays and plain values. All are exact
copies. This module imports nothing of the JAX package: the caller
converts the reference's arrays to numpy first.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
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
