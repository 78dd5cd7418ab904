#!/usr/bin/env python3
"""Time K1 (fused seeds) of two source trees in turns on one CUDA card.

    python3 tools/ab_k1.py OLD_TREE [NEW_TREE]

A tree is a checkout, or an unpacked ``git archive``, that holds
``src/repro_torch``; NEW_TREE defaults to this checkout. Each run is a
process of its own (both trees' packages are called ``repro_torch``), in
the order old, new, new, old, on the same inputs: ``fused_seeds_fvals``
(seeds and f-values) and ``fused_seeds`` (seeds only) at the main path's
two shapes, n = 1,056,777 (one 1,048,576-row chunk plus one 8201-slot
slab: the shard fold) and n = 16,402 (two slabs: the upkeep fold), for
five objective lists: 8 x sum, 8 x moment(1.5), 4 x moment(1.5) then
4 x sum, the 8-objective smoke spec of ``chip_smoke.py`` and 1 x sum;
each warm and with a cold L2, beside a device-to-device copy of the same
byte count (the rate a pure copy reaches). At n = 1,056,777 with the
smoke spec it also times K1 followed by K2's select of its seeds
([8, 1,056,777], k = 1025, as ``multisketch_select`` calls it) and the
device time of K2's first radix pass after K1 under the profiler, and
each run ends with one profiled absorb's device time. Times as
``chip_smoke.py`` takes them (CUDA events, median of 21, from its helpers
in this checkout). Every run hashes its outputs (SHA-256 of their bytes),
and the hashes must agree between the trees.

To compare K1's store policies, pass as OLD_TREE a copy of this tree
whose ``csrc/seeds.cu`` writes the f-values with plain stores
(``store_row<true>`` and ``store<true>`` made ``<false>``).

Prints the card's name and power limit, one ``AB {...}`` JSON line per run
and a summary line; exits non-zero without a card.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (1_056_777, 16_402)
SPECS = {"sum8": ((0, 0.0),) * 8, "moment8": ((4, 1.5),) * 8,
         "moment4": ((4, 1.5),) * 4 + ((0, 0.0),) * 4,
         "f1": ((0, 0.0),)}          # "smoke8": chip_smoke's spec


def inputs(torch, n, dev):
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, n).astype(
        np.int32)).to(dev)
    w = torch.from_numpy(rng.lognormal(0, 1.5, n).astype(np.float32)).to(dev)
    act = torch.from_numpy(rng.random(n) < 0.99).to(dev)
    return keys, w, act


def specs(cs, C):
    out = dict(SPECS)
    out["smoke8"] = cs.smoke_spec(C, "ppswor").kernel_objectives()
    return out


def nbytes(n: int, nf: int, fvals: bool) -> int:
    """Bytes K1 must move: key, weight, active read once; F seeds (and F
    f-values) written once."""
    return n * 9 + nf * n * 4 * (2 if fvals else 1)


def digest(x) -> str:
    """SHA-256 of a tensor's bytes, in order."""
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()


def worker(tree: Path) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import chip_smoke as cs
    import repro_torch.core as C
    import repro_torch.kernels as K
    from repro_torch.launch import query as query_mod
    if not Path(C.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"repro_torch came from {C.__file__}, not {tree}")
    dev = torch.device("cuda")
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    out = dict(tree=str(tree))
    for n in SHAPES:
        keys, w, act = inputs(torch, n, dev)
        for name, enc in specs(cs, C).items():
            for mode in ("fvals", "seeds"):
                if mode == "fvals":
                    def fn(enc=enc):
                        return K.fused_seeds_fvals(keys, w, act, enc,
                                                   "ppswor", 17)
                    s, f = fn()
                    check = [digest(s), digest(f)]
                else:
                    def fn(enc=enc):
                        return K.fused_seeds(keys, w, act, enc, "ppswor", 17)
                    check = [digest(fn())]
                tag = f"n{n}_{name}_{mode}"
                out[f"{tag}_check"] = check
                out[f"{tag}_ms"] = cs.cuda_ms(torch, fn)
                out[f"{tag}_cold_ms"] = cs.cuda_ms_cold(torch, fn, flush)
        # a device-to-device copy moving the bytes of the F = 8 f-value run
        src = torch.empty(nbytes(n, 8, True) // 2, dtype=torch.uint8,
                          device=dev)
        dst = torch.empty_like(src)
        out[f"n{n}_copy_ms"] = cs.cuda_ms(torch, lambda: dst.copy_(src))
        if n == SHAPES[0]:
            enc = cs.smoke_spec(C, "ppswor").kernel_objectives()

            def k1_k2():
                s = K.fused_seeds_fvals(keys, w, act, enc, "ppswor", 17)[0]
                return K.batched_bottomk_select(s, 1025)
            out["k1_k2_ms"] = cs.cuda_ms(torch, k1_k2)
            out["k2_first_pass_ms"] = first_pass_ms(torch, k1_k2)
    dev_ms, wall_ms, top = _ab_k2k6().profiled_absorb(torch, cs, C,
                                                      query_mod)
    out.update(absorb_device_ms=dev_ms, absorb_wall_ms=wall_ms,
               absorb_top=top)
    return out


def _ab_k2k6():
    spec = importlib.util.spec_from_file_location(
        "ab_k2k6", ROOT / "tools" / "ab_k2k6.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def first_pass_ms(torch, fn, calls: int = 20) -> float:
    """Device ms of K2's first radix pass (the first of the three
    ``select_hist_kernel`` launches of each call) after whatever ``fn``
    runs before it, under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hist = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "select_hist_kernel" in e.name),
                  key=lambda e: e.time_range.start)
    if len(hist) != 3 * calls:
        raise SystemExit(f"expected 3 radix passes per select, got "
                         f"{len(hist)} over {calls} calls")
    return float(np.median([e.self_device_time_total / 1e3
                            for e in hist[::3]]))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--worker":
        print("AB " + json.dumps(worker(Path(argv[1]))), flush=True)
        return 0
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab_k1: no CUDA device available", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    old = Path(argv[0]).resolve()
    new = Path(argv[1]).resolve() if len(argv) == 2 else ROOT
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
    summary = {}
    for key in sorted(k for k in runs["new"][0] if k.endswith("_ms")):
        row = {label: [r[key] for r in rs] for label, rs in runs.items()}
        parts = key.split("_")
        if parts[1] in ("f1", *SPECS, "smoke8"):
            n, nf = int(parts[0][1:]), 1 if parts[1] == "f1" else 8
            row["bound_ms"] = nbytes(n, nf, parts[2] == "fvals") / 3.35e9
        summary[key] = row
    print(json.dumps(summary), flush=True)
    checks = {label: {json.dumps({k: r[k] for k in r if k.endswith("check")})
                      for r in rs} for label, rs in runs.items()}
    if len(checks["old"] | checks["new"]) != 1:
        print("ab_k1: the trees' outputs differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
