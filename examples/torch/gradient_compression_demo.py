"""Sampled gradient exchange demo on the port: the paper's technique in
place of the cross-pod all-reduce (the twin of
``examples/gradient_compression_demo.py``).

    PYTHONPATH=src python examples/torch/gradient_compression_demo.py [--steps N] [--device cpu]

Runs the same training twice on a 2x2x2 (pod, data, model) mesh of 8
processes over gloo (``tcp://localhost``, one process per rank, as
``tests/test_torch_placement.py`` launches them): once with the dense
cross-pod all-reduce, once with the multi-objective sampled exchange
(``distopt.compression``, k = 256, leaves of 1,024 elements or more
sampled). qwen2-1.5b's smoke config, seed 0, one batch of 8 x 64 tokens
(numpy's generator at seed 0). Prints both loss curves and the bytes
that cross pods in a step, as the step's collectives book them
(``launch/cost.py``). On the CUDA card unless ``--device cpu`` (the
ranks share the card; gloo stages their collectives through the host).
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

WORLD = 8
K, MIN_SIZE = 256, 1024


def _train(mesh, compress, steps: int, device):
    """(losses, cross-pod bytes of the first step)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import cost
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import steps as St
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    cfg = get_smoke_config("qwen2-1.5b")
    opt = adamw.OptConfig(total_steps=60, warmup_steps=2, peak_lr=5e-3)
    params, _ = Mod.init_model(cfg, seed=0, device=device)
    step, specs = St.make_train_step(
        cfg, opt, mesh,
        compress=dict(k=K, min_size=MIN_SIZE) if compress else None)
    state = Sh.place({"params": params, "opt": adamw.init_opt_state(params)},
                     specs, mesh)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 64))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device)}
    losses, xpod = [], 0
    for i in range(steps):
        if i == 0:
            with cost.recording() as rec:
                state, m = step(state, batch)
            xpod = int(rec.coll_bytes_xpod)
        else:
            state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, xpod


def worker(rank: int, world: int, port: str, out: str, steps: int,
           device=None):
    """One rank: the dense run, then the sampled one; rank 0 writes the
    result to ``out``/result.json."""
    import torch
    import torch.distributed as dist
    from repro_torch import resolve_device
    from repro_torch.launch.mesh import Mesh
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    dev = resolve_device(device)
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"), device=dev)
    dense, dense_bytes = _train(mesh, False, steps, mesh.device)
    sampled, sampled_bytes = _train(mesh, True, steps, mesh.device)
    if rank == 0:
        with open(Path(out) / "result.json", "w") as f:
            json.dump({"dense": dense, "sampled": sampled,
                       "dense_xpod_bytes": dense_bytes,
                       "sampled_xpod_bytes": sampled_bytes}, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def run(steps: int, device=None) -> dict:
    """Spawn the 8 ranks and return rank 0's result."""
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="grad_demo_") as out:
        cmd = [sys.executable, __file__, "--steps", str(steps)]
        if device is not None:
            cmd += ["--device", str(device)]
        procs = [subprocess.Popen(
            cmd + ["--worker", str(r), str(WORLD), port, out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} failed:\n{log[-3000:]}")
        with open(Path(out) / "result.json") as f:
            return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12,
                    help="train steps of each run (fewer: shorter)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--worker", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "PORT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        rank, world, port, out = args.worker
        worker(int(rank), int(world), port, out, args.steps, args.device)
        return None
    res = run(args.steps, args.device)
    print("step | dense loss | sampled-exchange loss")
    for i, (d, s) in enumerate(zip(res["dense"], res["sampled"])):
        print(f"{i:4d} | {d:10.4f} | {s:10.4f}")
    print(f"\ncross-pod bytes of a step on rank 0: dense all-reduce "
          f"{res['dense_xpod_bytes']:,}, sampled exchange "
          f"{res['sampled_xpod_bytes']:,} (a 3k = {3 * K}-slot slab of "
          f"16 B a slot per sampled leaf block, the leaves under "
          f"{MIN_SIZE:,} elements dense)")
    return res


if __name__ == "__main__":
    main()
