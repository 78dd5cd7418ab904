"""Spans and counters of the train step, recorded while a ``torch.profiler``
records and at no other time.

``span(name, on)`` is a context manager around one piece of a step's work;
``count(name, n)`` adds to a counter. Recording follows the profiler's own
switch (``torch.autograd.profiler._is_profiler_enabled``): there is no
other. With it off a span is that one attribute read and an empty context
manager, and a count returns at once: no CUDA event, no kernel, no sync.

With it on, each span keeps its name, its step (an id that every span
under one root span shares), its parent, its host start and end on
``time.perf_counter_ns`` with the offset to ``time.time`` read when its
root opened (the rule that puts the benchmark's spans on the profiler's
clock), and, on a CUDA device, a pair of timing events recorded on the
current stream at its edges. The events are resolved only by the readers
(``spans``), never inside the step. An event adds no operation of the
device's to the profiler's trace.

One stack serves the whole process: under remat, backward and its
recompute run on autograd's device thread for CUDA tensors, while the
caller waits in ``torch.autograd.grad``, and a span opened there gets the
open backward span as its parent.

Host waits. While a root span on a CUDA device is open,
``torch.cuda.set_sync_debug_mode("warn")`` reports each synchronizing
operation as a warning; the recorder counts each under ``host_waits``
against the innermost open span (backward's are replayed by autograd at
the end of ``torch.autograd.grad``, so they fall on the span around it)
and shows none. The allocator's ``num_device_free`` and
``num_alloc_retries`` are read at the edges of the root span and of its
children, and their deltas are added to ``host_waits`` of the span the
interval belongs to (a ``cudaFree`` waits for the device).
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

SYNC_WARNING = "called a synchronizing CUDA operation"
_ALLOC_WAITS = ("num_device_free", "num_alloc_retries")
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    step: int                  # shared by every span under one root
    parent: int                # index in ``spans()``; -1 for a root
    start_s: float             # host clock, on time.time's scale
    end_s: Optional[float]     # None while the span is open
    device_ms: Optional[float]  # the stream's time between the edges


class Count(NamedTuple):
    name: str
    step: int                  # -1 outside every span
    span: Optional[str]        # the innermost open span's name
    value: int


def recording() -> bool:
    """True while a ``torch.profiler`` records."""
    return _profiler._is_profiler_enabled


class _Open:
    """One span while it is open (the context manager that ``span`` gives
    while recording)."""
    __slots__ = ("name", "on", "index")

    def __init__(self, name: str, on):
        self.name, self.on = name, on

    def __enter__(self):
        self.index = _REC.open(self.name, self.on)
        return self

    def __exit__(self, *exc):
        _REC.close(self.index)
        return False


class _Rec:
    """What the recorder keeps of one span."""
    __slots__ = ("name", "step", "parent", "t0", "t1", "offset", "device",
                 "start", "end")

    def __init__(self, name, step, parent, offset, device):
        self.name, self.step, self.parent = name, step, parent
        self.offset, self.device = offset, device
        self.t0 = self.t1 = 0                   # perf_counter_ns
        self.start = self.end = None            # CUDA events


class Recorder:
    """The process's spans and counters (one instance, ``_REC``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.records: list = []     # _Rec, in opening order
        self.stack: list = []       # indices of the open spans
        self.counts: dict = {}      # (name, step, span) -> [int, [tensors]]
        self.step = 0
        self.watch = None           # (catch_warnings, sync mode)
        self.shown = None           # the warnings' display before ours
        self.alloc = None           # allocator readings at the last edge

    # ------------------------------------------------------------ spans
    def open(self, name: str, on) -> int:
        parent = self.stack[-1] if self.stack else -1
        if parent < 0:
            self.step += 1
            offset = time.time() - time.perf_counter_ns() * 1e-9
            dev = _device(on)
        else:
            up = self.records[parent]
            offset = up.offset
            dev = up.device if on is None else _device(on)
        cuda = dev is not None and dev.type == "cuda"
        if parent < 0:
            self._watch(dev if cuda else None)
        elif cuda and len(self.stack) == 1:
            self._alloc_edge(dev, parent)       # the root's own interval
        rec = _Rec(name, self.step, parent, offset, dev)
        self.records.append(rec)
        self.stack.append(len(self.records) - 1)
        if cuda:
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.start.record(torch.cuda.current_stream(dev))
        rec.t0 = time.perf_counter_ns()
        return len(self.records) - 1

    def close(self, index: int):
        if not self.stack or self.stack[-1] != index:
            return                              # opened before a reset
        self.stack.pop()
        rec = self.records[index]
        rec.t1 = time.perf_counter_ns()
        if rec.start is not None:
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.end.record(torch.cuda.current_stream(rec.device))
            if len(self.stack) <= 1:
                self._alloc_edge(rec.device, index)
        if not self.stack:
            self._unwatch()

    # ---------------------------------------------------------- counters
    def add(self, name: str, n, span: Optional[int] = None):
        """Add ``n`` (a host int or a device tensor) to ``name`` in the
        span at ``span`` (default: the innermost open one)."""
        if span is None:
            span = self.stack[-1] if self.stack else -1
        rec = self.records[span] if span >= 0 else None
        key = (name, rec.step, rec.name) if rec else (name, -1, None)
        slot = self.counts.setdefault(key, [0, []])
        if isinstance(n, torch.Tensor):
            slot[1].append(n)
        else:
            slot[0] += int(n)

    # -------------------------------------------------------- host waits
    def _watch(self, dev):
        """From a root span's open: count reported syncs (and, on a card,
        have them reported) until it closes."""
        cw = warnings.catch_warnings()
        cw.__enter__()
        self.shown = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = self._shown
        mode = None
        if dev is not None:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            self.alloc = _alloc_waits(dev)
        self.watch = (cw, mode)

    def _unwatch(self):
        if self.watch is None:
            return
        cw, mode = self.watch
        self.watch = self.alloc = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        cw.__exit__(None, None, None)

    def _shown(self, message, category, filename, lineno, file=None,
               line=None):
        if str(message).startswith(SYNC_WARNING):
            self.add("host_waits", 1)
        else:       # e.g. the sync debug mode's own notice as it is set
            self.shown(message, category, filename, lineno, file, line)

    def _alloc_edge(self, dev, owner: int):
        """The allocator's waits since the last edge, added to the span
        ``owner`` whose interval ends here."""
        if self.alloc is None:
            return
        now = _alloc_waits(dev)
        self.add("host_waits", now - self.alloc, owner)
        self.alloc = now

    # ----------------------------------------------------------- readers
    def spans(self) -> list:
        out = []
        for r in self.records:
            ms = None
            if r.end is not None:
                r.end.synchronize()
                ms = r.start.elapsed_time(r.end)
            out.append(Span(r.name, r.step, r.parent, r.offset + r.t0 * 1e-9,
                            r.offset + r.t1 * 1e-9 if r.t1 else None, ms))
        return out

    def count_list(self) -> list:
        out = []
        for (name, step, span), (host, dev) in self.counts.items():
            total = host + sum(int(t.sum()) for t in dev)
            out.append(Count(name, step, span, total))
        return out


def _device(on) -> Optional[torch.device]:
    if on is None:
        return None
    return on.device if isinstance(on, torch.Tensor) else torch.device(on)


def _alloc_waits(dev) -> int:
    st = torch.cuda.memory_stats_as_nested_dict(dev)
    return sum(int(st.get(k, 0)) for k in _ALLOC_WAITS)


_REC = Recorder()


def span(name: str, on=None):
    """A context manager that records the span ``name`` while a profiler
    records. ``on``: a tensor or device the span's work runs on (CUDA:
    timed by stream events); by default the parent span's."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, on)


def count(name: str, n):
    """Add ``n`` to the counter ``name`` of the innermost open span while a
    profiler records: a host int, or a tensor whose elements are summed on
    its device (read back only by ``counts``). Meta tensors count
    nothing."""
    if not _profiler._is_profiler_enabled:
        return
    if isinstance(n, torch.Tensor):
        if n.is_meta:
            return
        n = n.sum()
    _REC.add(name, n)


def spans() -> list:
    """Every span recorded since ``reset``, in opening order (a span's
    ``parent`` indexes this list), the stream events resolved: the first
    call after a step waits for the device."""
    return _REC.spans()


def counts() -> list:
    """Every counter as ``Count(name, step, span, value)``, device sums
    read back."""
    return _REC.count_list()


def reset():
    """Forget every span and counter."""
    _REC.reset()
