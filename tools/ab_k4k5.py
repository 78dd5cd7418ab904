#!/usr/bin/env python3
"""Time K4 (segment query) and K5 (service cost) of two source trees in
turns on one CUDA card.

    python3 tools/ab_k4k5.py OLD_TREE [NEW_TREE]

A tree is a checkout, or an unpacked ``git archive``, that holds
``src/repro_torch``; NEW_TREE defaults to this checkout. Each run is a
process of its own (both trees' packages are called ``repro_torch``), in
the order old, new, new, old, on the same inputs: K4 at c = 8201, F = 8,
B = 256 (a slab of the serving smoke spec and two coalesced predicate
tables of 128) and B = 1, K5 at c = 4098, dim = 68, Cmax = 20, Q = 128
and Q = 16, each beside its ``torch.matmul`` yardstick, timed as
``chip_smoke.py`` times them (CUDA events, median of 21, from its
helpers in this checkout). Prints the card's name and power limit, one
``AB {...}`` JSON line per run and a summary line; exits non-zero
without a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: Path) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import chip_smoke as cs
    import repro_torch.core as C
    import repro_torch.kernels as K
    from repro_torch.core import costs as CO
    if not Path(C.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"repro_torch came from {C.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    spec = cs.smoke_spec(C, "ppswor")
    enc = spec.kernel_objectives()
    n = cs.CHUNK
    keys = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, n).astype(
        np.int32)).to(dev)
    w = torch.from_numpy(rng.lognormal(0, 1.5, n).astype(np.float32)).to(dev)
    act = torch.from_numpy(rng.random(n) < 0.99).to(dev)
    slab = C.multisketch_build(spec, keys, w, act)
    stacked = torch.cat([torch.from_numpy(cs.predicate_table(
        C, rng, 2 ** 31 - 1)) for _ in range(2)]).to(dev)
    args = (slab.keys, slab.weights, slab.probs, slab.member)
    ht = torch.where(slab.member, 1.0 / torch.clamp_min(slab.probs, 1e-30),
                     torch.zeros_like(slab.probs))
    contrib = torch.stack([f(slab.weights) for f, _ in spec.objectives]) * ht
    sel_t = C.predicate_matrix(slab.keys, stacked).to(
        torch.float32).T.contiguous()
    q4 = K.segment_query_slab(*args, stacked, enc)
    out = dict(tree=str(tree), c4=int(slab.keys.shape[0]),
               b4=int(stacked.shape[0]), k4_sum=float(q4.double().sum()))
    out["k4_ms"] = cs.cuda_ms(torch, lambda: K.segment_query_slab(
        *args, stacked, enc))
    one = stacked[:1].contiguous()
    out["k4_b1_ms"] = cs.cuda_ms(torch, lambda: K.segment_query_slab(
        *args, one, enc))
    out["k4_matmul_ms"] = cs.cuda_ms(torch, lambda: torch.matmul(contrib,
                                                                 sel_t))
    rng5 = np.random.default_rng(11)
    c5 = cs.SLAB_K + 2
    for q in (16, 128):
        s5, t5 = cs.k5_inputs(torch, CO, dev, q, 20, cs.CENSUS_DIM, c5, 2.0,
                              rng5)
        out[f"k5_q{q}_sum"] = float(K.service_cost_slab(*s5, t5).double()
                                    .sum())
        out[f"k5_q{q}_ms"] = cs.cuda_ms(torch, lambda: K.service_cost_slab(
            *s5, t5))
    flat = t5.centers.reshape(-1, cs.CENSUS_DIM)
    pts_t = s5[0].T.contiguous()
    out["k5_matmul_ms"] = cs.cuda_ms(torch, lambda: torch.matmul(flat,
                                                                 pts_t))
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--worker":
        print("AB " + json.dumps(worker(Path(argv[1]))), flush=True)
        return 0
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab_k4k5: no CUDA device available", file=sys.stderr)
        return 2
    old = Path(argv[0]).resolve()
    new = Path(argv[1]).resolve() if len(argv) == 2 else ROOT
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = {"old": [], "new": []}
    for label, tree in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        proc = subprocess.run([sys.executable, __file__, "--worker",
                               str(tree)], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        res = json.loads(lines[-1][3:])
        res["label"] = label
        runs[label].append(res)
        print("AB " + json.dumps(res), flush=True)
    keys = ("k4_ms", "k4_b1_ms", "k4_matmul_ms", "k5_q128_ms", "k5_q16_ms",
            "k5_matmul_ms")
    print(json.dumps({label: {k: [r[k] for r in rs] for k in keys}
                      for label, rs in runs.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
