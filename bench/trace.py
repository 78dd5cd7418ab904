"""Reading a profiler trace of a few of the window's steps: device
intervals, busy and idle time, the device operations that took most time,
and the idle gaps by what the host was doing.

The profiler records the device's activity alone (no host operations, so
that it adds little host time to the steps it covers). What the host was
doing comes from the benchmark's own spans around its calls into the
program (``bench.<name>``), taken on the host's clock and put on the
trace's clock (the wall clock, in seconds) by one offset read when the
profiler starts."""
from __future__ import annotations

import dataclasses
from collections import defaultdict

SPAN = "bench."


@dataclasses.dataclass
class Trace:
    device: list        # [(name, start_s, end_s)] device operations
    spans: list         # [(name, start_s, end_s)] the benchmark's spans
    steps: int          # profiled steps

    @property
    def window(self):
        return (min(s for _, s, _ in self.spans),
                max(e for _, _, e in self.spans))

    def busy(self, clip: bool = True) -> list:
        """The union of the device intervals (inside the window, with
        ``clip``)."""
        lo, hi = self.window if clip else (float("-inf"), float("inf"))
        out = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        """Seconds in which a device operation ran. The profiler runs
        only over the traced steps, each started and ended by a
        synchronise, so every operation it holds is theirs: none is
        clipped away, whatever the two clocks' offset."""
        return sum(e - s for s, e in self.busy(clip=False))

    def outside_s(self) -> float:
        """Device seconds outside the host's window: a reading over a few
        milliseconds means the offset between the clocks is off."""
        return self.busy_s() - sum(e - s for s, e in self.busy())

    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def kernel_time(self, match) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name
        ``match`` accepts."""
        hits = [(s, e) for n, s, e in self.device if match(n)]
        return sum(e - s for s, e in hits), len(hits)

    def top_ops(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for name, s, e in self.device:
            tot[name[:100]] += e - s
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda x: -x[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time by the span the host was in: each span's total, then
        the longest single gaps (named by the span at their middle), as
        [name, seconds]."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        total = defaultdict(float)
        labelled = []
        for s, e in gaps:
            for span, a, b in self.spans:
                cut = min(e, b) - max(s, a)
                if cut > 0:
                    total[span[len(SPAN):]] += cut
            mid = 0.5 * (s + e)
            name = next((sp for sp, a, b in self.spans if a <= mid <= b),
                        SPAN + "other")[len(SPAN):]
            labelled.append([f"longest.{name}", e - s])
        out = sorted(([k, v] for k, v in total.items()), key=lambda x: -x[1])
        longest = sorted(labelled, key=lambda x: -x[1])
        return (out + longest)[:n]


def activities(device) -> list:
    """What the profiler records: the card's activity alone on a card;
    the host's operations on a CPU run, which has no device to trace."""
    from torch.profiler import ProfilerActivity
    if device.type == "cuda":
        return [ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def from_profiler(prof, steps: int, spans: list) -> Trace:
    """A Trace from a finished ``torch.profiler.profile`` and the host's
    spans of the traced steps, ``[(name, start_s, end_s)]`` on the wall
    clock."""
    from torch.autograd import DeviceType
    device = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
            device.append((ev.name(), s, s + d))
    return Trace(device, list(spans), steps)
