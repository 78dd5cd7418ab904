"""The train step's spans and counters (``telemetry/spans.py``) on the CPU:
recording follows the profiler alone, spans nest with their parents and
steps (remat's recompute and the attention backward under the backward
span), recording changes no number of the step and no count of the dry
run, reported host waits land in the span they happen in, and the MoE
fill counters equal a direct count of the routing."""
import json
import os
import subprocess
import sys
import textwrap
import threading
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs import registry as R
from repro_torch.core import multisketch_empty
from repro_torch.launch import steps as St
from repro_torch.launch import train as Tr
from repro_torch.launch.mesh import AXES, Mesh
from repro_torch.models import model as Mod
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.telemetry import spans

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ARCH = "granite-moe-1b-a400m"


def recorded():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


def _step(compress=True, microbatch=2):
    cfg = R.get_smoke_config(ARCH)
    mesh = Mesh((1, 1, 1), AXES[3], device=CPU)
    opt = adamw.OptConfig(total_steps=20, warmup_steps=2, peak_lr=1e-3)
    step, _ = St.make_train_step(
        cfg, opt, mesh, microbatch=microbatch,
        compress=dict(k=16, min_size=1024) if compress else None,
        telemetry=Tr.TEL_SPEC)
    params, _ = Mod.init_model(cfg, seed=0, device=CPU)
    state = {"params": params, "opt": adamw.init_opt_state(params),
             "tel": multisketch_empty(Tr.TEL_SPEC, device=CPU)}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))
    return cfg, step, state, {"tokens": toks}


def _names(found, parent):
    return Counter(s.name for s in found if s.parent == parent)


def test_nothing_is_recorded_without_a_profiler():
    _, step, state, batch = _step()
    step(state, batch)
    with spans.span("x"):
        spans.count("c", 3)
    assert spans.spans() == [] and spans.counts() == []
    assert spans.span("x") is spans.span("y")      # one shared no-op


def test_spans_nest_with_their_parents_and_steps():
    cfg, step, state, batch = _step()
    with recorded():
        state, _ = step(state, batch)
        step(state, batch)
    found = spans.spans()
    roots = [i for i, s in enumerate(found) if s.parent == -1]
    assert [found[i].name for i in roots] == ["train.step"] * 2
    assert [found[i].step for i in roots] == [1, 2]
    L, parts = cfg.num_layers, 2
    for r in roots:
        assert _names(found, r) == {"train.forward": parts,
                                    "train.backward": parts,
                                    "exchange": 1, "train.update": 1}
        fwd = [i for i, s in enumerate(found)
               if s.parent == r and s.name == "train.forward"]
        bwd = [i for i, s in enumerate(found)
               if s.parent == r and s.name == "train.backward"]
        for i in fwd:
            assert _names(found, i) == {"attn": L, "moe.route": L}
        for i in bwd:
            # remat recomputes each layer (attn and route once more) and
            # the attention's own backward opens a span of its own
            assert _names(found, i) == {"attn": 2 * L, "moe.route": L}
    for s in found:
        assert s.start_s <= s.end_s and s.device_ms is None
        if s.parent >= 0:
            p = found[s.parent]
            assert p.step == s.step
            assert p.start_s <= s.start_s and s.end_s <= p.end_s


def test_a_span_on_another_thread_takes_the_open_span_as_parent():
    """Autograd runs a CUDA backward on its own thread while the caller
    waits: the stack is the process's, not the thread's."""
    with recorded():
        with spans.span("outer"):
            t = threading.Thread(target=lambda: spans.span("inner")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    outer, inner = spans.spans()
    assert (outer.name, inner.name) == ("outer", "inner")
    assert inner.parent == 0 and inner.step == outer.step


def test_recording_changes_no_number_of_the_step():
    _, step, state, batch = _step()
    plain, pm = step(state, batch)
    with recorded():
        traced, tm = step(state, batch)
    assert spans.spans()
    pt, tt = plain.pop("tel"), traced.pop("tel")
    for (p, a), (_, b) in zip(T.flatten(plain), T.flatten(traced)):
        assert torch.equal(a, b), p
    for f, a, b in zip(pt._fields, pt, tt):
        assert torch.equal(a, b), f
    assert set(pm) == set(tm)
    for k in pm:
        assert torch.equal(pm[k], tm[k]), k


_DRY = textwrap.dedent("""
    import json
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.dryrun import measure_step
    from repro_torch.launch.mesh import Mesh, init_dry_group
    from repro_torch.telemetry import spans
    init_dry_group(8)
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    cfg = get_smoke_config("granite-moe-1b-a400m")
    shape = ShapeConfig("smoke", 32, 8, "train")
    off = measure_step(cfg, shape, mesh, microbatch=2)[:2]
    with profile(activities=[ProfilerActivity.CPU]):
        on = measure_step(cfg, shape, mesh, microbatch=2)[:2]
    names = sorted({s.name for s in spans.spans()})
    print("RESULT " + json.dumps({"off": off, "on": on, "names": names}))
""")


def test_recording_leaves_the_dry_runs_counts_as_they_are():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", _DRY], capture_output=True,
                       text=True, env=env, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    assert "train.step" in out["names"] and "attn" in out["names"]
    assert out["on"] == out["off"]


def test_host_waits_land_in_the_span_they_happen_in():
    """The seam: a sync reported as the CUDA sync debug mode reports it
    (a warning) is counted against the innermost open span, and shown
    nowhere; other warnings pass through."""
    with warnings.catch_warnings(record=True) as shown, recorded():
        warnings.simplefilter("always")
        with spans.span("train.step"):
            warnings.warn(spans.SYNC_WARNING)
            with spans.span("exchange"):
                for _ in range(2):
                    warnings.warn(spans.SYNC_WARNING + " (Triggered "
                                  "internally at CUDAFunctions.cpp)")
                warnings.warn("another warning")
    assert [str(w.message) for w in shown] == ["another warning"]
    by = {(c.step, c.span): c.value for c in spans.counts()
          if c.name == "host_waits"}
    assert by == {(1, "train.step"): 1, (1, "exchange"): 2}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        warnings.warn(spans.SYNC_WARNING)     # after the step: shown again
    assert len(seen) == 1


def test_allocator_waits_go_to_the_interval_they_fall_in(monkeypatch):
    """The allocator's cudaFree and retry counts, read at the edges of the
    root and its children, are added to the span whose interval ends at
    the edge."""
    reads = iter([10, 13, 13, 20, 21])
    monkeypatch.setattr(spans, "_alloc_waits", lambda dev: next(reads))
    rec = spans.Recorder()
    rec.records = [spans._Rec("train.step", 1, -1, 0.0, None),
                   spans._Rec("train.backward", 1, 0, 0.0, None)]
    rec.alloc = spans._alloc_waits(None)           # the root opens: 10
    rec._alloc_edge(None, 0)                        # a child opens: 13
    rec._alloc_edge(None, 1)                        # it closes: 13
    rec._alloc_edge(None, 0)                        # 20: the root's own
    rec._alloc_edge(None, 0)                        # the root closes: 21
    by = {c.span: c.value for c in rec.count_list()}
    assert by == {"train.step": 3 + 7 + 1, "train.backward": 0}


def test_moe_fill_counts_equal_the_routing():
    """moe.kept / moe.slots are the forward's kept choices and expert
    rows, once per forward even where remat recomputes it in backward."""
    cfg = R.get_smoke_config(ARCH)
    params, _ = Mod.init_model(cfg, seed=0, device=CPU)
    p = T.tree_map(lambda t: t[0], params["layers"]["moe"])
    x = torch.randn(3, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0), requires_grad=True)
    r = MOE.route(p, x, cfg)
    E, C = max(cfg.num_experts, cfg.num_experts_padded), \
        MOE.moe_capacity(32, cfg)
    with recorded():
        with spans.span("train.step"):
            out = checkpoint(lambda t: MOE.apply_moe(p, t, cfg)[0], x,
                             use_reentrant=False)
            torch.autograd.grad(out.sum(), x)
    got = {c.name: c.value for c in spans.counts()}
    assert got == {"moe.kept": int(r.keep.sum()), "moe.slots": 3 * E * C}
    assert 0 < got["moe.kept"] < got["moe.slots"]
    routes = [s for s in spans.spans() if s.name == "moe.route"]
    assert len(routes) == 2                      # forward and recompute


def test_meta_tensors_count_nothing():
    with recorded():
        spans.count("c", torch.ones(4, device="meta"))
        spans.count("c", torch.ones(4, dtype=torch.bool))
        spans.count("c", 2)
    assert [(c.name, c.step, c.span, c.value)
            for c in spans.counts()] == [("c", -1, None, 6)]
