"""Per-stream write-ahead log for the serving tier (launch.pool).

The port's own copy of ``repro/launch/wal.py`` (numpy only), with the
byte-identical frame format: a log written by either package replays in
the other. Every accepted absorb chunk is appended here, fsync'd and
crc-framed, BEFORE the device fold runs, so a crash (or a fold failure
behind an open circuit breaker) never loses ingested data. Recovery is
restore-checkpoint -> replay the WAL tail -> fold; the fold is
deterministic and checkpoints store exact slab bits, so the recovered
engine is bit-identical to the uncrashed one.

Record framing (little-endian):

  magic  4s   b"MOW1"
  seq    u64  strictly increasing per stream (gaps allowed after pruning)
  shard  i32  target engine shard
  n      i32  row count
  crc    u32  crc32 over (seq, shard, n, payload)
  payload     keys int32[n] + weights float32[n] + active uint8[n]

Replay stops at the first torn/corrupt frame (short read, bad magic, crc
mismatch, non-increasing seq): a torn tail — the expected crash artifact —
silently yields every complete record before it; mid-file corruption is
treated the same way (conservative: the seq chain past it is suspect).

Control markers: a record with a NEGATIVE ``shard`` is a directive, not
data — replay must dispatch on the shard tag. Two kinds:

  * GC markers (``shard == GC_SHARD``, -1): the ``keys`` payload holds
    the VICTIM shard indices (int32) the engine merged into its base
    slab; weights/active are padding. The pool appends the marker AFTER
    a successful ``gc_apply`` (apply-then-append: a crash between the
    two loses only the GC directive, never data, and the merged union —
    hence every query answer — is identical either way), and recovery
    replays it as ``engine.gc_apply(keys)`` so the restored shard layout
    matches the uncrashed engine's exactly.
  * REBALANCE markers (``shard == REBALANCE_SHARD``, -2): the ``keys``
    payload holds a complete shard->host placement, written by the
    reference's multi-host pool. The port keeps the tag so the two
    packages agree on the frame format; its single-host pool writes none.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, NamedTuple, Optional

import numpy as np

_MAGIC = b"MOW1"
GC_SHARD = -1                  # marker record: keys = GC victim indices
REBALANCE_SHARD = -2           # marker record: keys = shard->host placement
_HEADER = struct.Struct("<4sQiiI")
_BODY = struct.Struct("<QiI")  # the crc-covered header fields (seq, shard, n)
_MAX_ROWS = 1 << 24            # frame sanity bound (rejects garbage lengths)


class WalRecord(NamedTuple):
    seq: int
    shard: int
    keys: np.ndarray     # int32 [n]
    weights: np.ndarray  # float32 [n]
    active: np.ndarray   # bool [n]


def _frame(seq: int, shard: int, keys, weights, active) -> bytes:
    keys = np.ascontiguousarray(keys, np.int32)
    weights = np.ascontiguousarray(weights, np.float32)
    active = np.ascontiguousarray(active, np.uint8)
    n = keys.shape[0]
    payload = keys.tobytes() + weights.tobytes() + active.tobytes()
    crc = zlib.crc32(_BODY.pack(seq, shard, n) + payload) & 0xFFFFFFFF
    return _HEADER.pack(_MAGIC, seq, shard, n, crc) + payload


class WriteAheadLog:
    """Append-only fsync'd chunk log; one file per stream."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        existed = os.path.exists(path)
        self._f = open(path, "ab")
        # highest intact seq, maintained incrementally: a brand-new/empty
        # log is known-0; an adopted non-empty log is unknown until the
        # first ``last_seq`` scan. ``append``/``prune`` keep it current so
        # steady-state ``last_seq`` never re-reads the file.
        self._last_seq: Optional[int] = 0 if self._f.tell() == 0 else None
        if not existed:
            # the file's first durability point: fsync the PARENT DIRECTORY
            # too, or a crash right after the first fsync'd ``append`` can
            # lose the directory entry — frame durable, file unreachable
            # (``prune`` already does this after its os.replace)
            if self.fsync:
                self._fsync_dir()

    def _fsync_dir(self):
        d = os.path.dirname(self.path) or "."
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # ------------------------------------------------------------- write
    def append(self, seq: int, shard: int, keys, weights, active):
        """Durably append one chunk record (fsync before returning — the
        write-ahead guarantee: once ``absorb`` acks, the chunk survives a
        crash even if its device fold never ran)."""
        if self._f is None:
            raise ValueError(
                f"append(seq={seq}) on closed WAL {self.path!r} — the log "
                f"was close()d; reopen with WriteAheadLog(path)")
        seq = int(seq)
        self._f.write(_frame(seq, int(shard), keys, weights, active))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        if self._last_seq is not None:
            if seq > self._last_seq:
                self._last_seq = seq
            else:
                # non-increasing append breaks the replay seq chain at an
                # earlier frame — the cached value no longer tracks it
                self._last_seq = None

    def prune(self, min_seq_exclusive: int):
        """Atomically rewrite the log keeping records with
        seq > ``min_seq_exclusive`` — called after a checkpoint snapshot so
        the log stays O(data since the oldest RETAINED snapshot), never
        O(stream lifetime).

        Streaming frame copy: each frame is validated (magic/length/crc/
        seq chain — the ``replay`` acceptance rules) and its RAW BYTES
        written through, one frame in memory at a time — pruning a
        near-full log is O(frame) memory, never O(log), and the retained
        bytes are identical to the source frames."""
        if self._f is None:
            raise ValueError(f"prune() on closed WAL {self.path!r}")
        self._f.flush()
        tmp = self.path + ".tmp"
        last_seq = 0
        last_kept = 0
        with open(self.path, "rb") as src, open(tmp, "wb") as dst:
            while True:
                head = src.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    break                    # EOF or torn header
                magic, seq, shard, n, crc = _HEADER.unpack(head)
                if magic != _MAGIC or not (0 <= n <= _MAX_ROWS):
                    break                    # corrupt frame
                payload = src.read(9 * n)
                if len(payload) < 9 * n:
                    break                    # torn payload
                if zlib.crc32(_BODY.pack(seq, shard, n) + payload) \
                        & 0xFFFFFFFF != crc:
                    break                    # bit rot / torn write
                if seq <= last_seq:
                    break                    # seq chain broken
                last_seq = seq
                if seq > min_seq_exclusive:
                    dst.write(head)
                    dst.write(payload)
                    last_kept = seq
            dst.flush()
            os.fsync(dst.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._fsync_dir()
        self._f = open(self.path, "ab")
        self._last_seq = last_kept

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    # -------------------------------------------------------------- read
    def replay(self, min_seq_exclusive: int = 0) -> Iterator[WalRecord]:
        """Yield intact records in order, stopping at the first torn or
        corrupt frame. Safe on a live log (reads a separate handle)."""
        if self._f is not None:
            self._f.flush()
        last_seq = 0
        with open(self.path, "rb") as f:
            while True:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    return                       # EOF or torn header
                magic, seq, shard, n, crc = _HEADER.unpack(head)
                if magic != _MAGIC or not (0 <= n <= _MAX_ROWS):
                    return                       # corrupt frame
                payload = f.read(9 * n)
                if len(payload) < 9 * n:
                    return                       # torn payload
                if zlib.crc32(_BODY.pack(seq, shard, n) + payload) \
                        & 0xFFFFFFFF != crc:
                    return                       # bit rot / torn write
                if seq <= last_seq:
                    return                       # seq chain broken
                last_seq = seq
                if seq <= min_seq_exclusive:
                    continue
                keys = np.frombuffer(payload, np.int32, n, 0).copy()
                weights = np.frombuffer(payload, np.float32, n, 4 * n).copy()
                active = np.frombuffer(payload, np.uint8, n, 8 * n
                                       ).astype(bool)
                yield WalRecord(seq, shard, keys, weights, active)

    def last_seq(self) -> int:
        """Highest intact sequence number (0 when empty). Cached: computed
        by one replay scan at most once per adopted log, then maintained
        incrementally by ``append``/``prune`` — steady-state calls never
        re-read the file."""
        if self._last_seq is None:
            seq = 0
            for r in self.replay():
                seq = r.seq
            self._last_seq = seq
        return self._last_seq
