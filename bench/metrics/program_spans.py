"""What the readers of the program's own spans and counters share. The
port records them (``repro_torch.telemetry.spans``) while a profiler
records, so in a ``--trace 1`` run they cover the traced steps alone.
A reader takes the steps whose ``train.step`` span lies inside the
trace's window (on the trace's clock, the wall clock) and gives its
reading per traced step (``run.trace.steps``). Without a trace, or with a
program that records no spans, every reader gives None; a reader of
device time gives None without a card too."""
from __future__ import annotations

# the program's and the benchmark's clock offsets are read apart
SLACK_S = 1e-3


def recorder():
    """The program's span recorder, or None for a program without one."""
    try:
        from repro_torch.telemetry import spans
    except ImportError:
        return None
    return spans


def traced(run):
    """(every recorded span, the ids of the traced steps), or None."""
    rec = recorder()
    if run.trace is None or rec is None or not run.trace.spans:
        return None
    lo, hi = run.trace.window
    found = rec.spans()
    steps = {s.step for s in found
             if s.name == "train.step" and s.parent == -1
             and s.end_s is not None
             and lo - SLACK_S <= s.start_s and s.end_s <= hi + SLACK_S}
    return (found, steps) if steps else None


def outermost(found: list, name: str, steps: set) -> list:
    """The closed spans called ``name`` in ``steps`` that no span of the
    same name holds."""
    out = []
    for s in found:
        if s.name != name or s.step not in steps or s.end_s is None:
            continue
        p = s.parent
        while p >= 0 and found[p].name != name:
            p = found[p].parent
        if p < 0:
            out.append(s)
    return out


def device_ms(run, name: str):
    """The stream-event intervals of ``name``'s spans, summed over the
    traced steps, per step (ms); None without them or without a card."""
    got = traced(run)
    if got is None:
        return None
    picked = outermost(got[0], name, got[1])
    if not picked or any(s.device_ms is None for s in picked):
        return None
    return sum(s.device_ms for s in picked) / run.trace.steps


def counted(run, name: str):
    """The counter ``name`` over the traced steps' spans, summed, or None
    without traced steps."""
    got = traced(run)
    if got is None:
        return None
    return sum(c.value for c in recorder().counts()
               if c.name == name and c.step in got[1])


def idle_ms(run, name: str):
    """Device idle inside the host's ``name`` spans: the gaps in the
    trace's busy intervals that fall inside each span, on the trace's
    clock, summed per traced step (ms); None without a card."""
    got = traced(run)
    if got is None or not run.trace.device:
        return None
    picked = outermost(got[0], name, got[1])
    if not picked:
        return None
    busy = run.trace.busy()
    idle = 0.0
    for s in picked:
        a, b = s.start_s, s.end_s
        idle += (b - a) - sum(max(0.0, min(e, b) - max(st, a))
                              for st, e in busy)
    return 1e3 * idle / run.trace.steps
