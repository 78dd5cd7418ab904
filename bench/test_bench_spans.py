"""The readers of the program's spans and counters (``program_spans`` and
the nine metrics that use it) on recorded spans with given device times
and a made-up trace, and on a traced smoke run on the CPU, where the
counters read numbers and the device times read None."""
import sys
import types

import pytest
import torch

from bench import harness as H
from bench import smoke
from bench.runners import train as R
from bench.trace import Trace
from repro_torch.telemetry import spans as S

DEVICE_TIME = ("fwd_ms.train", "bwd_ms.train", "attn_ms.train",
               "moe_route_ms.train", "update_ms.train", "exchange_ms.train")
COUNTERS = ("host_waits.train", "moe_fill.train")
T0 = 1_700_000_000.0


def _span(name, step, parent, a, b, ms):
    return S.Span(name, step, parent, T0 + a, T0 + b, ms)


# three steps: step 1 ran before the trace's window, steps 2 and 3 in it
SPANS = [
    _span("train.step", 1, -1, 0.0, 1.0, 900.0),            # 0
    _span("train.forward", 1, 0, 0.1, 0.3, 200.0),          # 1
    _span("train.step", 2, -1, 2.0, 3.0, 950.0),            # 2
    _span("train.forward", 2, 2, 2.0, 2.2, 210.0),          # 3
    _span("attn", 2, 3, 2.0, 2.05, 40.0),                   # 4
    _span("attn", 2, 4, 2.01, 2.02, 10.0),                  # 5 (nested)
    _span("moe.route", 2, 3, 2.06, 2.1, 30.0),              # 6
    _span("train.backward", 2, 2, 2.2, 2.6, 400.0),         # 7
    _span("attn", 2, 7, 2.3, 2.4, 80.0),                    # 8
    _span("exchange", 2, 2, 2.6, 2.8, 150.0),               # 9
    _span("train.update", 2, 2, 2.8, 3.0, 120.0),           # 10
    _span("train.step", 3, -1, 4.0, 5.0, 960.0),            # 11
    _span("train.forward", 3, 11, 4.0, 4.2, 230.0),         # 12
    _span("train.backward", 3, 11, 4.2, 4.6, 410.0),        # 13
    _span("exchange", 3, 11, 4.6, 4.8, 170.0),              # 14
    _span("train.update", 3, 11, 4.8, 5.0, 130.0),          # 15
]
COUNTS = [
    S.Count("host_waits", 1, "train.step", 7),
    S.Count("host_waits", 2, "exchange", 3),
    S.Count("host_waits", 3, "train.backward", 1),
    S.Count("host_waits", 3, "train.step", 2),
    S.Count("moe.kept", 1, "train.forward", 999),
    S.Count("moe.kept", 2, "train.forward", 60),
    S.Count("moe.kept", 3, "train.forward", 40),
    S.Count("moe.slots", 1, "train.forward", 1000),
    S.Count("moe.slots", 2, "train.forward", 125),
    S.Count("moe.slots", 3, "train.forward", 125),
]


def _run(spans=SPANS, device=None, trace=True):
    bench = [("bench.loader", T0 + 1.9, T0 + 2.0),
             ("bench.step_call", T0 + 2.0, T0 + 3.0),
             ("bench.sync", T0 + 3.0, T0 + 3.0),
             ("bench.loader", T0 + 3.9, T0 + 4.0),
             ("bench.step_call", T0 + 4.0, T0 + 5.0),
             ("bench.sync", T0 + 5.0, T0 + 5.0)]
    if device is None:
        device = [("k", T0 + 2.0, T0 + 2.65), ("k", T0 + 2.7, T0 + 2.75),
                  ("k", T0 + 4.0, T0 + 4.7), ("k", T0 + 4.75, T0 + 5.0)]
    tr = Trace(device, bench, 2) if trace else None
    return types.SimpleNamespace(trace=tr)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(S, "spans", lambda: list(SPANS))
    monkeypatch.setattr(S, "counts", lambda: list(COUNTS))


@pytest.mark.parametrize("name,want", [
    ("fwd_ms.train", (210.0 + 230.0) / 2),
    ("bwd_ms.train", (400.0 + 410.0) / 2),
    ("attn_ms.train", (40.0 + 80.0) / 2),       # the nested span once
    ("moe_route_ms.train", 30.0 / 2),
    ("update_ms.train", (120.0 + 130.0) / 2),
    ("exchange_ms.train", (150.0 + 170.0) / 2),
    # exchange 2.6-2.8 has busy 2.6-2.65 and 2.7-2.75: idle 0.1 s; the
    # one of step 3, 4.6-4.8, has 4.6-4.7 and 4.75-4.8: idle 0.05 s
    ("exchange_idle_ms.train", 1e3 * (0.1 + 0.05) / 2),
    ("host_waits.train", (3 + 1 + 2) / 2),
    ("moe_fill.train", 100.0 * 100 / 250),
])
def test_reader_arithmetic_over_the_traced_steps(recorded, name, want):
    # times near 1.7e9 s hold about 0.2 us: 1e-3 ms is far above that
    assert H.metric(name).read(_run()) == pytest.approx(want, abs=1e-3)


@pytest.mark.parametrize("name", DEVICE_TIME + COUNTERS
                         + ("exchange_idle_ms.train",))
def test_readers_are_silent_without_a_trace(recorded, name):
    assert H.metric(name).read(_run(trace=False)) is None


@pytest.mark.parametrize("name", DEVICE_TIME + ("exchange_idle_ms.train",))
def test_device_time_readers_are_silent_without_a_card(monkeypatch, name):
    cpu = [s._replace(device_ms=None) for s in SPANS]
    monkeypatch.setattr(S, "spans", lambda: cpu)
    monkeypatch.setattr(S, "counts", lambda: list(COUNTS))
    assert H.metric(name).read(_run(device=[])) is None


@pytest.mark.parametrize("name", DEVICE_TIME + COUNTERS
                         + ("exchange_idle_ms.train",))
def test_readers_are_silent_for_a_program_without_the_recorder(
        monkeypatch, name):
    import repro_torch.telemetry as tel
    monkeypatch.delattr(tel, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry.spans", None)
    assert H.metric(name).read(_run()) is None


def test_steps_outside_the_window_are_not_read(monkeypatch):
    """Only steps whose train.step lies inside the trace's window count:
    with none there, every reader is silent."""
    early = [s for s in SPANS if s.step == 1]
    monkeypatch.setattr(S, "spans", lambda: early)
    monkeypatch.setattr(S, "counts", lambda: list(COUNTS))
    for name in DEVICE_TIME + COUNTERS:
        assert H.metric(name).read(_run()) is None, name


def test_traced_smoke_run_reads_the_counters():
    """A traced run on the CPU: the program's counters read numbers, its
    device times nothing (no card), and the benchmark's own host metrics
    are still there."""
    S.reset()
    cell = smoke.cell("granite-moe-1b-a400m.train_4k")
    out = R.run(cell, seed=2 ** 31 + 7, seconds=0.5, trace=True,
                device=torch.device("cpu"), t_start=0.0)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert {"loader_ms.train", "dispatch_ms.train"} <= set(got)
    assert got["host_waits.train"]["value"] == 0
    assert got["host_waits.train"]["unit"] == "count"
    assert 0 < got["moe_fill.train"]["value"] <= 100
    for name in DEVICE_TIME + ("exchange_idle_ms.train",):
        assert name not in got
    S.reset()
