#!/usr/bin/env python3
"""Hold the train step's own spans and counters against the profiler's
trace, on one CUDA card.

    python3 tools/step_spans.py --workload <cell> --seed <n> \\
        [--seconds 51] [--trace 1] [--root TREE]
    python3 tools/step_spans.py --probe
    python3 tools/step_spans.py --cost <rounds> --workload <cell> --seed <n>

The first form runs one benchmark cell as ``bench/run.py`` runs it (the
same harness, in this process) and then prints one ``SPANS {...}`` JSON
line with, per traced step: the program's ``train.step`` against the
benchmark's ``bench.step_call`` on the trace's clock; the step's device
interval (the first to the last device operation from the step's start to
the benchmark's synchronise) against the stream intervals of its
``train.forward``, ``train.backward``, ``exchange`` and ``train.update``
spans; the device idle inside each of those host spans and inside the
step's own code; ``host_waits`` by span; and per step the trace's time
in the MoE slot count (``scan_outer_dim``), K1 and K2 against
``moe_route_ms.train`` and ``exchange_ms.train``. It also gives every
step's wall, traced or not. ``--root`` runs another tree (a checkout or
an unpacked ``git archive``) with its own ``bench/`` and ``src/``; a tree
without the recorder gives the walls alone.

``--probe`` checks the recorder alone: spans around no work add no device
operation to the trace, a planted ``.item()`` inside a span (and one in a
backward, which autograd replays at its end) raises ``host_waits`` there
by exactly 1, and the cost of a span with recording off and on.

``--cost`` builds the cell's program once and times whole steps in turns
(each variant, then each in reverse order, ``rounds`` times): untraced;
under the profiler with the recorder held off; under the profiler with
the recorder on; and on, without the sync debug mode, or without the
stream events. It prints one ``COST {...}`` line of step walls (from the
step call to its synchronise, the profiler's own start and stop left
out).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def _paths(root: Path):
    sys.path[:0] = [str(root), str(root / "src")]


def probe() -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.telemetry import spans
    dev = torch.device("cuda")
    x = torch.ones(1 << 20, device=dev)
    torch.cuda.synchronize()
    spans.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            with spans.span("a", x):
                with spans.span("b"):
                    pass
    torch.cuda.synchronize()
    made = [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    recorded = len(spans.spans())

    class Planted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t * 2

        @staticmethod
        def backward(ctx, g):
            g.sum().item()                       # one wait, in backward
            return g * 2

    spans.reset()
    w = torch.ones(1 << 20, device=dev, requires_grad=True)
    with profile(activities=[ProfilerActivity.CUDA]):
        with spans.span("train.step", x):
            with spans.span("planted"):
                (x * 2).sum().item()
            with spans.span("clean"):
                (x * 2).sum()
            with spans.span("train.backward"):
                torch.autograd.grad(Planted.apply(w).sum(), w)
    waits = {c.span: c.value for c in spans.counts()
             if c.name == "host_waits"}

    def per_span(n=100_000):
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span("x", x):
                pass
        return (time.perf_counter() - t0) / n * 1e6
    off_us = per_span()
    with profile(activities=[ProfilerActivity.CUDA]):
        with spans.span("root", x):
            on_us = per_span(20_000)
    spans.reset()
    return {"device_events_from_spans": len(made), "names": made[:5],
            "spans_recorded": recorded, "host_waits": waits,
            "span_us_off": off_us, "span_us_on": on_us}


def cost(workload: str, seed: int, rounds: int, device="cuda") -> dict:
    import types
    import torch
    from torch.profiler import ProfilerActivity, profile
    import bench.run  # noqa: F401  (the benchmark's caches and settings)
    from bench import harness as H
    from bench import trace as Tr
    from bench.runners import train as R
    from repro_torch.telemetry import spans
    dev = torch.device(device)
    prog = R.Program(H.resolve(workload), seed, dev)
    real, quiet = spans._profiler, types.SimpleNamespace(
        _is_profiler_enabled=False)
    sync_mode = torch.cuda.set_sync_debug_mode
    event = torch.cuda.Event

    class NoEvent:
        def __init__(self, **kw):
            pass

        def record(self, stream=None):
            pass

    def step(variant) -> float:
        batch = prog.batch()
        torch.cuda.synchronize()
        if variant == "untraced":
            t0 = time.perf_counter()
            prog.run_step(batch)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        spans._profiler = quiet if variant == "recorder off" else real
        if variant == "no sync mode":
            torch.cuda.set_sync_debug_mode = lambda mode: None
        if variant == "no events":
            torch.cuda.Event = NoEvent
        try:
            with profile(activities=Tr.activities(dev)):
                t0 = time.perf_counter()
                prog.run_step(batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            spans._profiler, torch.cuda.Event = real, event
            torch.cuda.set_sync_debug_mode = sync_mode
            spans.reset()
        return wall

    variants = ["untraced", "recorder off", "recorder on", "no sync mode",
                "no events"]
    for v in ("untraced", "recorder on"):       # warm both paths
        step(v)
    walls = {v: [] for v in variants}
    for _ in range(rounds):
        for v in variants + variants[::-1]:
            walls[v].append(round(step(v), 4))
    return {"workload": workload, "seed": seed, "walls": walls,
            "median": {v: statistics.median(w) for v, w in walls.items()}}


def _inside(busy, a, b) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy)


def analyse(run) -> dict:
    """The traced steps' spans against the trace (see the module's
    docstring)."""
    out = {"walls_untraced": [round(d - a, 4) for a, _, _, d, t
                              in run.spans if not t],
           "walls_traced": [round(d - a, 4) for a, _, _, d, t
                            in run.spans if t]}
    try:
        from repro_torch.telemetry import spans as S
    except ImportError:
        return out
    from bench.metrics import program_spans as P
    tr = run.trace
    got = P.traced(run)
    if got is None:
        return out
    found, steps = got
    waits = {}
    for c in S.counts():
        if c.name == "host_waits" and c.step in steps:
            waits[c.span] = waits.get(c.span, 0) + c.value
    out["host_waits_by_span"] = {k: v / tr.steps for k, v in waits.items()}
    if not tr.device:                    # no card: no device times
        return out
    busy = tr.busy()
    calls = [(a, b) for n, a, b in tr.spans if n == "bench.step_call"]
    syncs = [(a, b) for n, a, b in tr.spans if n == "bench.sync"]
    top = ("train.forward", "train.backward", "exchange", "train.update")
    rows = []
    for idx, root in enumerate(found):
        if root.parent != -1 or root.step not in steps:
            continue
        call = min(calls, key=lambda c: abs(c[0] - root.start_s))
        sync_end = min((b for a, b in syncs if a >= root.end_s - 1e-3),
                       default=root.end_s)
        ops = [(s, e) for _, s, e in tr.device
               if root.start_s <= s <= sync_end]
        first, last = min(s for s, _ in ops), max(e for _, e in ops)
        kids = [s for s in found if s.parent == idx]
        child_ms = {n: sum(k.device_ms for k in kids if k.name == n)
                    for n in top}
        idle = {n: 1e3 * sum(k.end_s - k.start_s
                             - _inside(busy, k.start_s, k.end_s)
                             for k in kids if k.name == n) for n in top}
        root_idle = 1e3 * (root.end_s - root.start_s - _inside(
            busy, root.start_s, root.end_s))
        idle["own code"] = root_idle - sum(idle.values())
        rows.append({
            "step": root.step,
            "in_step_call_ms": [1e3 * (root.start_s - call[0]),
                                1e3 * (call[1] - root.end_s)],
            "device_interval_ms": 1e3 * (last - first),
            "step_stream_ms": root.device_ms,
            "children_ms": child_ms,
            "children_sum_ms": sum(child_ms.values()),
            "host_ms": 1e3 * (root.end_s - root.start_s),
            "idle_ms": idle})
    out["steps"] = rows
    per = lambda names: tr.kernel_time(
        lambda n: any(k in n for k in names))[0] * 1e3 / tr.steps
    out["trace_ms_per_step"] = {
        "scan_outer_dim": per(("scan_outer_dim",)),
        "k1": per(("seeds_kernel",)),
        "k2": per(("select_hist_kernel", "select_count_kernel",
                    "select_write_kernel", "select_rank_kernel")),
        "busy": tr.busy_s() * 1e3 / tr.steps}
    out["spans_per_step"] = len([s for s in found if s.step in steps]) \
        / tr.steps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--cost", type=int, default=0, metavar="ROUNDS")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    _paths(root)
    if args.probe:
        print("PROBE " + json.dumps(probe()), flush=True)
        return 0
    if args.cost:
        print("COST " + json.dumps(cost(args.workload, args.seed,
                                        args.cost)), flush=True)
        return 0
    t_start = time.perf_counter()
    import bench.run  # noqa: F401  (the benchmark's caches and settings)
    from bench import harness as H
    seen = {}
    metric = H.metric

    def keeping(name):
        mod = metric(name)

        class Reader:
            @staticmethod
            def read(run):
                seen["run"] = run
                return mod.read(run)
        return Reader
    H.metric = keeping
    rc = H.main(["--workload", args.workload, "--seed", str(args.seed),
                 "--seconds", str(args.seconds), "--trace",
                 str(args.trace)], t_start)
    if "run" in seen:
        out = analyse(seen["run"])
        walls = out["walls_untraced"]
        out["untraced_median_s"] = statistics.median(walls) if walls \
            else None
        out.update(workload=args.workload, seed=args.seed, root=str(root))
        print("SPANS " + json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
