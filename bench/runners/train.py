"""The training runner: the port's train step as ``repro_torch.launch.train``
builds and runs it, on one card, timed over a window of whole steps and
checked against the plain reference.

Set-up builds the step (``launch.steps.make_train_step`` with the
trainer's telemetry spec and, where the traffic asks, the sampled exchange
and the importance-sampled loader), places the state on a 1 x 1 x 1
(pod, data, model) mesh with the benchmark's own weights from the seed,
and drives that same step through its first three steps on the loader's
first three batches, as the trainer does. Those steps warm up every shape
of the window and are the ones checked: their losses, the first moment
after step 1, each leaf's change after step 3, the telemetry sketch's
keys, and (with the exchange) the wire slab of every sampled leaf at
step 1, read through a tap on the exchange's leaf sampler that keeps
what it returns and a host copy of the gradient it was given. The window
then runs whole steps (loader, step call, synchronise, as the trainer's
loop) until ``seconds`` have passed since it opened, timed to the
synchronise after the last. After the window the program's state is
freed and the reference follows the checked steps from the same weights
and batches.

The time spent reading the checked steps (norms, host copies) is left out
of ``setup_s``.
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
import types

import torch

from bench import check as Chk
from bench import harness as H
from bench import trace as Tr
from bench import weights as Wt
from bench.reference import sample as RefSample
from bench.reference import train as RefTrain

CHECK_STEPS = 3
TRACE_STEPS = 2


def optimizer(traffic: dict) -> dict:
    """The optimizer's settings; the warmup as the trainer sets it."""
    opt = dict(traffic["optimizer"])
    opt["warmup_steps"] = opt["total_steps"] // 20 + 1
    return opt


def rows_of(cell) -> int:
    """The chip's share of the global batch."""
    return cell.traffic["global_batch"] // cell.config["batch_ranks"]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    """The system under test, built as the trainer builds it."""

    def __init__(self, cell, seed: int, device):
        from repro_torch import tree as T
        from repro_torch.core import multisketch_empty
        from repro_torch.data.pipeline import DataConfig, Loader, \
            SyntheticCorpus
        from repro_torch.launch import sharding as Sh
        from repro_torch.launch import steps as St
        from repro_torch.launch import train as TR
        from repro_torch.launch.mesh import AXES, Mesh
        from repro_torch.models import model as Mod
        from repro_torch.models.config import ModelConfig
        from repro_torch.optim import adamw

        self.T, self.TR = T, TR
        self.device = device
        self.seed = seed
        self.cell = cell
        self.cfg = ModelConfig(**cell.config["model"])
        tr = cell.traffic
        self.rows = rows_of(cell)
        self.parts = cell.config["microbatch"]
        self.opt = optimizer(tr)
        o = self.opt
        opt_cfg = adamw.OptConfig(
            peak_lr=o["peak_lr"], min_lr_frac=o["min_lr_frac"],
            warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
            b1=o["b1"], b2=o["b2"], eps=o["eps"],
            weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
        mesh = Mesh((1, 1, 1), AXES[3], device=device)
        self.dcfg = DataConfig(vocab_size=self.cfg.vocab_size,
                               seq_len=tr["seq_len"], global_batch=self.rows,
                               seed=seed, n_docs=tr["n_docs"])
        self.loader = Loader(SyntheticCorpus(self.dcfg), self.dcfg,
                             importance=tr["importance_sampling"],
                             device=device)
        ex = tr.get("exchange")
        self.exchange = ex
        compress = None if ex is None else dict(
            k=ex["k"], min_size=ex["min_size"], cap_frac=ex["cap_frac"],
            seed=ex["seed"])
        self.step_fn, _ = St.make_train_step(
            self.cfg, opt_cfg, mesh,
            microbatch=self.parts if self.parts > 1 else None,
            compress=compress, telemetry=TR.TEL_SPEC)
        shardings, _ = St.state_shardings(self.cfg, mesh, TR.TEL_SPEC)
        abstract, _ = Mod.abstract_params(self.cfg)
        self.shapes = {p: tuple(t.shape) for p, t in T.flatten(abstract)}
        params = T.unflatten(Wt.draw_all(self.shapes, seed, device).items())
        self.state = Sh.place(
            {"params": params, "opt": adamw.init_opt_state(params),
             "tel": multisketch_empty(TR.TEL_SPEC, device=device)},
            shardings, mesh)
        del params
        self.step = 0

    def batch(self):
        raw = self.loader.batch(self.step)
        return self.TR.make_batch(self.cfg, raw, self.dcfg, self.device)

    def run_step(self, batch):
        self.state, metrics = self.step_fn(self.state, batch)
        self.step += 1
        return metrics

    def sampled(self) -> list:
        """(leaf index, path) of every leaf the exchange samples, in the
        order it samples them."""
        if self.exchange is None:
            return []
        return [(i, p) for i, p in enumerate(sorted(self.shapes))
                if math.prod(self.shapes[p]) >= self.exchange["min_size"]]

    def free(self):
        """Drop the program's state and its one-rank process group."""
        import torch.distributed as dist
        for name in ("state", "step_fn", "loader"):
            setattr(self, name, None)
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


@contextlib.contextmanager
def _tap(taps: list, clock: list):
    """Keep every wire slab the exchange's leaf sampler returns, with a
    host copy of the gradient it was given."""
    from repro_torch.distopt import compression as CP
    orig = CP._sample_leaf

    def tapped(g, k, seed, cap_frac, *a, **kw):
        sk = orig(g, k, seed, cap_frac, *a, **kw)
        t0 = time.perf_counter()
        taps.append({"seed": int(seed), "g": g.detach().to("cpu"),
                     "keys": sk.keys.clone(), "weights": sk.weights.clone(),
                     "probs": sk.probs.clone(), "valid": sk.valid.clone()})
        clock[0] += time.perf_counter() - t0
        return sk
    CP._sample_leaf = tapped
    try:
        yield
    finally:
        CP._sample_leaf = orig


def check_steps(prog: Program) -> dict:
    """Drive the program through its first steps and read what the checks
    compare. Returns the readings, with "check_s": the seconds spent
    reading them."""
    T = prog.T
    dev = prog.device
    clock = [0.0]
    out = {"loss": [], "tokens": [], "taps": [], "step_walls": []}
    for t in range(CHECK_STEPS):
        ts = time.perf_counter()
        batch = prog.batch()
        out["tokens"].append(batch["tokens"].cpu())
        tap = (_tap(out["taps"], clock) if t == 0 and prog.exchange
               else contextlib.nullcontext())
        with tap:
            metrics = prog.run_step(batch)
        _sync(dev)
        out["loss"].append(float(metrics["loss"]))
        t0 = time.perf_counter()
        out["step_s"] = t0 - ts
        out["step_walls"].append(round(t0 - ts, 3))
        if t == 0:
            b1 = prog.opt["b1"]
            out["grad_clipped"] = {
                p: float(m.norm()) / (1 - b1)
                for p, m in T.flatten(prog.state["opt"]["m"])}
        clock[0] += time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        out["change"] = {}
        for i, (p, w) in enumerate(T.flatten(prog.state["params"])):
            w0 = Wt.draw_leaf(p, prog.shapes[p], prog.seed, i, dev)
            out["change"][p] = float((w - w0).norm())
            del w0
    tel = prog.state["tel"]
    valid = tel.valid.cpu()
    out["tel_keys"] = tel.keys.cpu()[valid].tolist()
    clock[0] += time.perf_counter() - t0
    out["check_s"] = clock[0]
    return out


def reference(cell, shapes, seed, readings, device, quant=None,
              keep_rows=None, frozen=False) -> dict:
    """The reference following the checked steps from the same weights
    and batches (``RefTrain.follow``'s faults and precision passed on)."""
    m = cell.config["model"]
    rcfg = types.SimpleNamespace(
        **m, d_inner=m.get("ssm_expand", 0) * m["d_model"])
    return RefTrain.follow(rcfg, shapes, seed, readings["tokens"],
                           cell.config["microbatch"],
                           optimizer(cell.traffic), device, quant,
                           keep_rows, frozen)


def sample_misses(prog: Program, readings: dict, device) -> int:
    """``check.slab_misses`` over every sampled leaf at the first step."""
    ex = prog.exchange
    want = prog.sampled()
    taps = readings["taps"]
    if len(taps) != len(want):
        return sum(min(3 * ex["k"], math.prod(prog.shapes[p]))
                   for _, p in want) or 1
    miss = 0
    for (i, p), tap in zip(want, taps):
        seed = RefSample.exchange_seed(ex["seed"], i, 0, 0)
        miss += int(tap["seed"] != seed)
        ref = RefSample.sample(tap["g"].to(device), ex["k"], seed,
                               ex["cap_frac"])
        miss += Chk.slab_misses({k: tap[k].to(device) for k in ref}, ref)
        del ref
    return miss


def numbers(prog: Program, readings: dict, ref: dict, device) -> dict:
    out = {"loss_gap": Chk.loss_gap(readings["loss"], ref["loss"]),
           "grad_gap": Chk.grad_gap(readings["grad_clipped"], ref),
           "grad_med": Chk.grad_med(readings["grad_clipped"], ref),
           "change_gap": Chk.change_gap(readings["change"], ref),
           "tel_miss": float(Chk.tel_miss(readings["tel_keys"],
                                          len(ref["loss"]), prog.rows))}
    if prog.exchange is not None:
        out["sample_miss"] = float(sample_misses(prog, readings, device))
    return out


def window(prog: Program, seconds: float, trace: bool, step_s: float):
    """Whole steps until ``seconds`` have passed: (spans [(start, loaded,
    returned, synchronised, traced)], Trace or None, launches per step or
    None, the last step's loss). With ``trace``, TRACE_STEPS steps near
    the window's middle (``step_s``: a warm step's seconds) run under the
    profiler (the window runs on until they have), which records the
    device's activity; the host's spans of those steps go into the Trace
    on the wall clock."""
    from repro_torch import kernels as K
    dev = prog.device
    K.reset_launch_counts()
    spans, prof, tr, host = [], None, None, []
    est = max(int(seconds / max(step_s, 1e-3)), 1)
    first = max(1, est // 2 - TRACE_STEPS // 2)
    t0 = time.perf_counter()
    loss = None
    while True:
        ta = time.perf_counter()
        if ta - t0 >= seconds and spans and (not trace or tr is not None):
            break
        n = len(spans)
        traced = trace and first <= n < first + TRACE_STEPS
        if traced and prof is None:
            prof = torch.profiler.profile(activities=Tr.activities(dev))
            prof.__enter__()
            wall = time.time() - time.perf_counter()
            ta = time.perf_counter()
        batch = prog.batch()
        tb = time.perf_counter()
        metrics = prog.run_step(batch)
        tc = time.perf_counter()
        _sync(dev)
        td = time.perf_counter()
        spans.append((ta, tb, tc, td, traced))
        loss = metrics["loss"]
        if traced:
            host += [(Tr.SPAN + name, wall + a, wall + b) for name, a, b in
                     (("loader", ta, tb), ("step_call", tb, tc),
                      ("sync", tc, td))]
        if traced and n == first + TRACE_STEPS - 1:
            prof.__exit__(None, None, None)
            tr = Tr.from_profiler(prof, TRACE_STEPS, host)
    counts = K.launch_counts()
    per_step = ({k: v / len(spans) for k, v in counts.items()}
                if dev.type == "cuda" else None)
    return spans, tr, per_step, float(loss)


def _parts(spans) -> list:
    return [(round(b - a, 3), round(c - b, 3), round(d - c, 3))
            for a, b, c, d, _ in spans]


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    prog = Program(cell, seed, device)
    built = time.perf_counter() - t_start
    readings = check_steps(prog)
    readings["built_s"] = built
    setup_peak = win_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = (time.perf_counter() - t_start) - readings["check_s"]
    spans, tr, per_step, last_loss = window(prog, seconds, trace,
                                            readings["step_s"])
    win = spans[-1][3] - spans[0][0]
    alloc = ""
    if device.type == "cuda":
        win_peak = torch.cuda.max_memory_allocated(device)
        st = torch.cuda.memory_stats(device)
        alloc = (f"; allocator retries {st.get('num_alloc_retries')}, "
                 f"cudaMalloc {st.get('num_device_alloc')}, cudaFree "
                 f"{st.get('num_device_free')}")
    tokens = prog.rows * cell.traffic["seq_len"]
    record = types.SimpleNamespace(
        cell=cell, shapes=prog.shapes, spans=spans, trace=tr,
        launches_per_step=per_step, window_s=win, tokens_per_step=tokens,
        window_peak_bytes=win_peak,
        device_name=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else device.type))
    # the program's state goes before the reference runs
    prog.free()
    t_ref = time.perf_counter()
    ref = reference(cell, prog.shapes, seed, readings, device)
    print(f"setup {setup_s:.3f} s (built {readings['built_s']:.3f}, checked "
          f"steps {readings['step_walls']}, reading them "
          f"{readings['check_s']:.3f} s more); window {win:.3f} s, steps "
          f"(loader, call, sync) {_parts(spans)}{alloc}; reference "
          f"{time.perf_counter() - t_ref:.3f} s, its change counted on "
          f"{len(Chk.counted(ref))} of {len(ref['change'])} leaves",
          file=sys.stderr)
    if tr is not None:
        print(f"trace: {tr.steps} steps, device busy {tr.busy_s():.3f} s, "
              f"host window {tr.window_s():.3f} s, device time outside "
              f"it {tr.outside_s():.4f} s", file=sys.stderr)
    correct, checks = Chk.judge(numbers(prog, readings, ref, device),
                                cell.limits)
    finite = math.isfinite(last_loss)
    metrics = {}
    if trace:
        for spec in cell.per_layer:
            value = H.metric(spec["name"]).read(record)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        values = {"train_tokens_per_s": len(spans) * tokens / win,
                  "setup_s": setup_s}
        for spec in cell.end_to_end:
            metrics[spec["name"]] = {"value": values[spec["name"]],
                                     "unit": spec["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": record.device_name, "count": cell.chips,
           "memory_peak_bytes": int(max(setup_peak, win_peak)),
           "power": H.power_limit() if device.type == "cuda" else "none"}
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
    out = {"correct": bool(correct and finite),
           "attempted": CHECK_STEPS + len(spans), "failed": int(not finite),
           "metrics": metrics, "device": dev, "window_steps": len(spans)}
    if trace and tr is not None:
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out
