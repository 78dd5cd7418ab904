"""Carry slab state between the JAX package and the port.

A reference ``MultiSketch`` is 8 arrays in a fixed field order (keys,
weights, probs, seeds, member, aux, valid, taus). ``from_arrays`` turns
those arrays (numpy, or anything ``np.asarray`` accepts) into the port's
``MultiSketch`` on a device; ``to_arrays`` gives the 8 fields back as
numpy arrays, from which the reference rebuilds its own slab. Both are
exact copies. This module imports nothing of the JAX package: the caller
converts the reference's arrays to numpy first.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.multi_sketch import MultiSketch

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
