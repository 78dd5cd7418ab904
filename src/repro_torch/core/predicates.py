"""Segment-predicate wire format for batched segment queries Q^(f, H).

Port of ``repro/core/predicates.py``. One int32 row of ``PRED_COLS``
columns per predicate:

  col 0  lo     value-range lower bound (inclusive)
  col 1  hi     value-range upper bound (inclusive)
  col 2  mask   bitmask test: (v & mask) == want   (mask 0 -> always true)
  col 3  want
  col 4  salt   hash seed for ON_HASH predicates
  col 5  flags  bit 0 (ON_HASH): test v = hash31(key, salt) instead of key

All tests AND together, plus key >= 0 (slot occupied).
``predicate_matrix`` is the plain evaluation the segment-query kernel
(``kernels/segquery``) reproduces on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

from .hashing import hash_u32

PRED_COLS = 6
FLAG_ON_HASH = 1
INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1
_HASH31_SPAN = 2 ** 31


@dataclasses.dataclass(frozen=True)
class SegmentPredicate:
    """One segment predicate H: keys with ``lo <= v <= hi`` and
    ``(v & mask) == want``, v = key or hash31(key, salt) when ``on_hash``."""

    lo: int = INT32_MIN
    hi: int = INT32_MAX
    mask: int = 0
    want: int = 0
    salt: int = 0
    on_hash: bool = False

    def row(self) -> np.ndarray:
        """The predicate's int32 wire row [PRED_COLS]."""
        return np.array([self.lo, self.hi, self.mask, self.want, self.salt,
                         FLAG_ON_HASH if self.on_hash else 0], np.int32)

    def __call__(self, keys) -> torch.Tensor:
        """Vectorized key predicate -> bool [n]."""
        return predicate_matrix(keys, self.row()[None, :])[0]


EVERYTHING = SegmentPredicate()


def key_range(lo: int, hi: int) -> SegmentPredicate:
    """Keys in [lo, hi] inclusive."""
    return SegmentPredicate(lo=int(lo), hi=int(hi))


def key_mask(mask: int, want: int) -> SegmentPredicate:
    """Keys with (key & mask) == want."""
    return SegmentPredicate(mask=int(mask), want=int(want))


def hash_fraction(q: float, salt: int = 0) -> SegmentPredicate:
    """A coordinated uniform q-fraction of the key space: keys whose 31-bit
    hash (keyed by ``salt``) falls below q * 2^31."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"fraction q={q} outside [0, 1]")
    return SegmentPredicate(lo=0, hi=int(q * _HASH31_SPAN) - 1,
                            salt=int(salt), on_hash=True)


Predicates = Union[SegmentPredicate, Sequence[SegmentPredicate], np.ndarray,
                   torch.Tensor]


def encode_predicates(preds: Predicates) -> np.ndarray:
    """-> int32 wire table [B, PRED_COLS]. Accepts one predicate, a
    sequence of predicates, or an already-encoded table."""
    if isinstance(preds, SegmentPredicate):
        return preds.row()[None, :]
    if isinstance(preds, (np.ndarray, torch.Tensor)):
        if isinstance(preds, torch.Tensor):
            preds = preds.cpu().numpy()
        t = np.asarray(preds, np.int32)
        if t.ndim != 2 or t.shape[1] != PRED_COLS:
            raise ValueError(
                f"predicate table must be [B, {PRED_COLS}], got {t.shape}")
        return t
    rows = [p.row() for p in preds]
    if not rows:
        raise ValueError("empty predicate batch")
    return np.stack(rows)


def never_row() -> np.ndarray:
    """A row matching nothing (lo > hi): the batch padding element."""
    return np.array([1, 0, 0, 0, 0, 0], np.int32)


def pad_table(table: np.ndarray, b_pad: int) -> np.ndarray:
    """Pad a wire table to ``b_pad`` rows with never-matching predicates."""
    b = table.shape[0]
    if b >= b_pad:
        return table
    return np.concatenate([table, np.tile(never_row(), (b_pad - b, 1))])


def hash31(keys, salt) -> torch.Tensor:
    """Top 31 bits of hash_u32(key, salt) as int32 in [0, 2^31)."""
    return (hash_u32(keys, salt) >> 1).to(torch.int32)


def predicate_matrix(keys, table) -> torch.Tensor:
    """Evaluate a wire table against keys: [B, PRED_COLS] x [n] -> bool
    [B, n] (on the keys' device)."""
    k = torch.as_tensor(keys).to(torch.int32)[None, :]          # [1, n]
    t = torch.as_tensor(np.asarray(table, np.int32)
                        if not isinstance(table, torch.Tensor) else table,
                        device=k.device).to(torch.int32)
    lo, hi = t[:, 0:1], t[:, 1:2]
    mask, want = t[:, 2:3], t[:, 3:4]
    salt, flags = t[:, 4:5], t[:, 5:6]
    hv = hash31(k, salt)                                        # [B, n]
    v = torch.where((flags & FLAG_ON_HASH) != 0, hv, k)
    return (v >= lo) & (v <= hi) & ((v & mask) == want) & (k >= 0)
