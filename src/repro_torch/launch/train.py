"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 200 --batch 8 --seq 128 [--smoke] [--device cpu] \\
        [--ckpt-dir DIR [--resume]] [--compress] [--importance-sampling] \\
        [--mesh 1x1x1]

Port of ``repro/launch/train.py``: the config registry, the synthetic data
pipeline (+ optional multi-objective importance sampling), AdamW, the
checkpoint manager (atomic, keep-k, resume from the newest intact step),
the in-step telemetry sketch, the optional sampled gradient exchange, and
preemption handling (SIGTERM -> checkpoint -> exit 0).

Runs on the card unless ``--device cpu``. One process runs at world size 1;
for several, start one per rank with ``--dist-url tcp://localhost:<port>
--world-size N --rank R`` (gloo on the CPU, NCCL on cards), and a
``--mesh`` whose size is N; its ``model`` axis may be > 1 (tensor
parallelism) and a config with ``fsdp`` places its params and moments
over ``data``. The state is placed (each rank holds its blocks); every
rank takes part in a checkpoint and rank 0 writes the whole arrays, and
every rank restores them and keeps its blocks, so a checkpoint restores
onto another mesh. Under ``--compress`` pods drift apart by design, so a
resume restarts every pod from pod 0's state.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)
from repro_torch.core import (COUNT, SUM, MultiSketchSpec, multisketch_empty,
                              sketch_estimate, thresh)
from repro_torch.data.pipeline import DataConfig, Loader, SyntheticCorpus
from repro_torch.launch import sharding as Sh
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import AXES, Mesh, make_host_mesh
from repro_torch.models import model as Mod
from repro_torch.optim import adamw

# device-resident per-step telemetry, folded inside every train step
TEL_SPEC = MultiSketchSpec(
    objectives=((SUM, 64), (COUNT, 64), (thresh(5.0), 64)), seed=1234)


def parse_mesh(spec: str, device=None) -> Mesh:
    """"" -> (data, model) over every rank; "PxDxM" / "DxM" / "D" -> that
    mesh."""
    if not spec:
        return make_host_mesh(device=device)
    dims = tuple(int(x) for x in spec.split("x"))
    return Mesh(dims, AXES[len(dims)], device=device)


def _stub_embeddings(shape, seed: int, device):
    """Standard normal bf16 embeddings of a stub frontend, the same for
    every call with the same seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(
        torch.bfloat16)


def make_batch(cfg, raw, dcfg, device):
    """The loader's host batch -> the model's inputs on ``device``. An
    encoder gets stub frames (seed 0, the same every step) and the tokens
    as labels; a vlm stub patches (seed 1) before its first
    ``max(S - frontend_tokens, 8)`` tokens."""
    toks = torch.from_numpy(raw["tokens"]).to(device)
    B, S = toks.shape
    if cfg.family == "encoder":
        return {"frames": _stub_embeddings((B, S, cfg.d_model), 0, device),
                "labels": toks % cfg.vocab_size}
    if cfg.family == "vlm":
        P = cfg.frontend_tokens
        return {"tokens": toks[:, :max(S - P, 8)],
                "patches": _stub_embeddings((B, P, cfg.d_model), 1, device)}
    return {"tokens": toks}


def build_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="", help="e.g. 2x2x1 (pod,data,model)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="sampled cross-pod gradient exchange")
    ap.add_argument("--importance-sampling", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--dist-url", default="",
                    help="tcp://localhost:<port> to start a process group")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None, callback=None):
    """Train; returns the final state. ``callback(event, **info)`` sees
    ``"restored"`` (state, step) after a resume, ``"start"`` (state, step)
    just before the first step and ``"step"`` (step, state, metrics,
    seconds: the step's synchronised wall time) after every step."""
    args = build_args(argv)
    callback = callback or (lambda event, **info: None)
    dev = resolve_device(args.device)
    if args.dist_url and not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=args.dist_url, rank=args.rank,
                                world_size=args.world_size)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = parse_mesh(args.mesh, device=dev)
    dev = mesh.device
    opt_cfg = adamw.OptConfig(peak_lr=args.lr,
                              warmup_steps=args.steps // 20 + 1,
                              total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      n_docs=20_000)
    corpus = SyntheticCorpus(dcfg)
    loader = Loader(corpus, dcfg, importance=args.importance_sampling,
                    device=dev)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    step_fn, _ = St.make_train_step(
        cfg, opt_cfg, mesh, microbatch=args.microbatch or None,
        compress=dict(k=256, min_size=65536) if args.compress else None,
        telemetry=TEL_SPEC)
    shardings, _ = St.state_shardings(cfg, mesh, TEL_SPEC)

    params, _ = Mod.init_model(cfg, seed=args.seed, device=dev)
    state = Sh.place({"params": params, "opt": adamw.init_opt_state(params),
                      "tel": multisketch_empty(TEL_SPEC, device=dev)},
                     shardings, mesh)
    del params
    start = 0
    if mgr and args.resume:
        restored, rstep = mgr.restore_latest(state, shardings)
        if restored is None:
            # checkpoints from before the telemetry sketch lack the "tel"
            # arrays: restore params/opt and start telemetry fresh
            core = {kk: state[kk] for kk in ("params", "opt")}
            restored, rstep = mgr.restore_latest(
                core, {kk: shardings[kk] for kk in core})
            if restored is not None:
                restored = {**restored, "tel": state["tel"]}
        if restored is not None:
            state, start = restored, rstep
            print(f"[train] resumed from step {start}", flush=True)
            callback("restored", state=state, step=start)

    # preemption: checkpoint on SIGTERM, exit cleanly
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True
    signal.signal(signal.SIGTERM, _on_sigterm)

    callback("start", state=state, step=start)
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        ts = time.perf_counter()
        batch = make_batch(cfg, loader.batch(step), dcfg, dev)
        state, metrics = step_fn(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        callback("step", step=step + 1, state=state, metrics=metrics,
                 seconds=time.perf_counter() - ts)
        if (step + 1) % args.log_every == 0 or step == start:
            dt = (time.perf_counter() - t0) / max(step - start + 1, 1)
            print(f"step {step + 1:5d} loss {float(metrics['loss']):8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"{dt * 1e3:7.1f} ms/step", flush=True)
        if mgr and ((step + 1) % args.ckpt_every == 0
                    or preempted["flag"]):
            mgr.save(step + 1, state, blocking=False, shardings=shardings)
        if preempted["flag"]:
            print(f"[train] preempted at step {step + 1}; checkpointed")
            if mgr:
                mgr.wait()
            sys.exit(0)

    if mgr:
        mgr.save(args.steps, state, blocking=True, shardings=shardings)

    # the device-resident multi-objective summary answers several
    # f-statistics over the whole training history
    tel = state["tel"]
    print("[telemetry] sketch size:", int(torch.sum(tel.member)))
    print("[telemetry] est total loss mass:",
          float(sketch_estimate(tel, SUM)))
    print("[telemetry] est #obs with loss>=5:",
          float(sketch_estimate(tel, thresh(5.0))), flush=True)
    return state


if __name__ == "__main__":
    main()
