"""Multi-pod dry run: every (arch x shape x mesh) cell's step on meta
tensors, at the production layout.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell's jitted step for 512 placeholder CPU devices and reads XLA's memory
analysis and its own HLO cost model. The port has no compiler: each rank
runs its own eager program. So a cell here builds rank 0's placed state on
the meta device (``init_model(..., device="meta")``, ``sharding.place``)
inside a ``fake`` default group at the production world size
(``mesh.init_dry_group``: the real ``make_production_mesh``, its real axis
groups, collectives that return at once), calls the port's own
``make_train_step`` / ``make_prefill_step`` / ``make_serve_step`` once
under ``launch/cost.py``'s recorder, and writes per-rank ``memory`` and
``hlo_cost`` beside ``lower_s`` (the walk's wall seconds) and ``status``.
The cells, the skips (``cell_is_runnable``), ``DEFAULT_MICROBATCH`` and the
JSON keys are the reference's; ``compile_s`` is 0 and ``xla_cost`` empty
(nothing is compiled). The kernels on a step's path (the exchange's K1/K2,
the telemetry fold's K1-K3) take their meta branches, which book their
bytes.

A cell's default group lives as long as its process, so every cell of
``--all`` runs in a subprocess of its own (as the reference's does); one
over ``--timeout`` seconds is recorded as ``timeout``. A decode cell steps
from the last slot of its cache (``seq_len - 1``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--out-dir DIR] [--jobs N]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

# the reference's grad-accumulation factors for train cells
DEFAULT_MICROBATCH = {
    "deepseek-67b": 16, "internvl2-76b": 16, "falcon-mamba-7b": 4,
    "zamba2-2.7b": 4, "phi3-mini-3.8b": 2, "qwen2-moe-a2.7b": 4,
    "granite-moe-1b-a400m": 2, "hubert-xlarge": 2, "gemma-2b": 2,
    "qwen2-1.5b": 2,
}


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and (named) tuples."""
    import torch
    from torch.utils._pytree import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


def _with_overrides(cfg, overrides: str):
    """``k=v,k=v`` config overrides, typed as the fields they replace."""
    if not overrides:
        return cfg
    import dataclasses
    typed = {}
    for item in overrides.split(","):
        k, v = item.split("=", 1)
        cur = getattr(cfg, k)
        typed[k] = v if isinstance(cur, str) else type(cur)(eval(v))
    return dataclasses.replace(cfg, **typed)


def measure_step(cfg, shape, mesh, microbatch: int = 1, compress=False,
                 telemetry=None, trip_counts: bool = True):
    """One call of (cfg x shape)'s step as rank 0 of ``mesh`` on meta
    tensors: (memory, hlo_cost, wall seconds). Train cells take AdamW's
    defaults, ``microbatch`` parts and, with ``compress``, the sampled
    exchange (True: k = 512, the reference's; a dict: its kwargs);
    ``telemetry``: a MultiSketchSpec folded by the train step;
    ``trip_counts=False`` walks every iteration of every loop (tests)."""
    from repro_torch.launch import cost
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import steps as St
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    batch = St.input_specs(cfg, shape)
    rows = _nbytes(Sh.place(batch, Sh.batch_shardings(batch, mesh), mesh))
    t0 = time.perf_counter()
    if shape.kind == "train":
        step, specs = St.make_train_step(
            cfg, adamw.OptConfig(), mesh,
            microbatch=microbatch if microbatch > 1 else None,
            compress=(dict(k=512) if compress is True else compress or None),
            telemetry=telemetry)
        state = Sh.place(St.abstract_state(cfg, telemetry)[0], specs, mesh)
        args = (state, batch)
        call = lambda: step(state, batch)
    elif shape.kind == "prefill":
        step, psp, _ = St.make_prefill_step(cfg, mesh, shape=shape)
        params = Sh.place(Mod.abstract_params(cfg)[0], psp, mesh)
        args = (params, batch)
        call = lambda: step(params, batch)
    else:
        step, psp, csp = St.make_serve_step(cfg, shape, mesh)
        params = Sh.place(Mod.abstract_params(cfg)[0], psp, mesh)
        cache = Sh.place(St.cache_abstract(cfg, shape), csp, mesh)
        args = (params, batch["tokens"], cache)
        call = lambda: step(params, batch["tokens"], cache,
                            shape.seq_len - 1)
    held = _tensors(args)
    with cost.recording(held, trip_counts) as rec:
        out = call()
    wall = time.perf_counter() - t0
    arg_bytes = _nbytes(args[0]) + rows + sum(_nbytes(a) for a in args[2:])
    return cost.memory(rec, arg_bytes, out, held), rec.hlo_cost(), wall


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatch: int = 0, overrides: str = "",
             compress: bool = False) -> dict:
    """One cell at the production layout, (16, 16) or (2, 16, 16), in this
    process (which then holds the dry group for good)."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config, sub_quadratic
    from repro_torch.configs.shapes import SHAPES, cell_is_runnable
    from repro_torch.launch.mesh import init_dry_group, make_production_mesh

    cfg = _with_overrides(get_config(arch), overrides)
    shape = SHAPES[shape_name]
    ok, reason = cell_is_runnable(cfg.family, shape, sub_quadratic(cfg))
    result = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16",
              "family": cfg.family}
    if not ok:
        result.update(status="skipped", reason=reason)
        return result
    if not dist.is_initialized():
        init_dry_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    if microbatch == 0 and shape.kind == "train":
        microbatch = DEFAULT_MICROBATCH.get(arch, 1)
    mem, hlo, wall = measure_step(cfg, shape, mesh, microbatch or 1,
                                  compress)
    print(f"[{arch} x {shape_name} x {result['mesh']}] walk {wall:.1f}s "
          f"({hlo['n_ops']:,} ops)")
    print("memory:", mem)
    print("hlo_cost:", {k: v for k, v in hlo.items() if k != "coll_ops"})
    print("collectives:", hlo["coll_ops"])
    result.update(status="ok", lower_s=round(wall, 1), compile_s=0.0,
                  memory=mem, xla_cost={}, hlo_cost=hlo,
                  microbatch=microbatch, overrides=overrides,
                  compress=compress)
    return result


def _cell_cmd(a: str, s: str, mp: bool, out: str, args) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
           "--shape", s, "--out", out]
    if mp:
        cmd.append("--multi-pod")
    if args.microbatch:
        cmd += ["--microbatch", str(args.microbatch)]
    if args.overrides:
        cmd += ["--overrides", args.overrides]
    if args.compress:
        cmd.append("--compress")
    return cmd


def run_all(args) -> int:
    """Every cell in a subprocess of its own, ``args.jobs`` at a time;
    returns the number of cells that ended in error or timeout."""
    from repro_torch.configs.registry import list_archs
    from repro_torch.configs.shapes import SHAPES
    os.makedirs(args.out_dir, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs = []
    for a in list_archs():
        for s in SHAPES:
            for mp in meshes:
                tag = f"{a}__{s}__{'mp' if mp else 'sp'}"
                out = os.path.join(args.out_dir, tag + ".json")
                if os.path.exists(out):
                    print("skip (exists):", tag)
                else:
                    jobs.append((a, s, mp, out))
    failures, running = 0, []
    while jobs or running:
        while jobs and len(running) < args.jobs:
            a, s, mp, out = jobs.pop(0)
            print(">>>", a, s, "2x16x16" if mp else "16x16", flush=True)
            running.append((subprocess.Popen(_cell_cmd(a, s, mp, out, args)),
                            time.time(), (a, s, mp, out)))
        time.sleep(0.2)
        for item in list(running):
            proc, t0, (a, s, mp, out) = item
            if proc.poll() is None and time.time() - t0 <= args.timeout:
                continue
            running.remove(item)
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                failures += 1
                with open(out, "w") as f:
                    json.dump({"arch": a, "shape": s,
                               "mesh": "2x16x16" if mp else "16x16",
                               "status": "timeout"}, f)
            elif proc.returncode != 0:
                failures += 1
    print("done; failures:", failures)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--overrides", default="",
                    help="cfg overrides k=v,k=v (perf iterations)")
    ap.add_argument("--compress", action="store_true",
                    help="sampled cross-pod gradient exchange (train cells)")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once under --all")
    args = ap.parse_args(argv)
    if args.all:
        return 1 if run_all(args) else 0
    try:
        result = run_cell(args.arch, args.shape, args.multi_pod,
                          args.microbatch, args.overrides, args.compress)
    except Exception:
        result = {"arch": args.arch, "shape": args.shape,
                  "mesh": "2x16x16" if args.multi_pod else "16x16",
                  "status": "error", "error": traceback.format_exc()}
        print(result["error"], file=sys.stderr)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if result.get("status") in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
