#!/usr/bin/env python3
"""Time K2 (bottom-k select) and K6 (rank counts) of two source trees in
turns on one CUDA card, and the device time of one profiled absorb.

    python3 tools/ab_k2k6.py OLD_TREE [NEW_TREE]
    python3 tools/ab_k2k6.py --profile

A tree is a checkout, or an unpacked ``git archive``, that holds
``src/repro_torch``; NEW_TREE defaults to this checkout. Each run is a
process of its own (both trees' packages are called ``repro_torch``), in
the order old, new, new, old, on the same inputs: ``batched_bottomk_select``
at the main path's two shapes (the smoke spec's 8 seed rows of
1,056,777 keys at k = 1025, as multisketch_select calls it, and one row of
compaction priorities at k = 8201, as compact_take calls it), warm and
with a cold L2, beside a stable ``torch.sort`` of the rows;
``rank_counts`` on the capping operands of 2^20 keys; and one warm absorb
of a 1,048,576-row chunk into a ``SegmentQueryEngine`` (fold + upkeep,
drained) under the profiler: its device time and the sum of its kernels
by name. Times as ``chip_smoke.py`` takes them (CUDA events, median of 21,
from its helpers in this checkout). Prints the card's name and power
limit, one ``AB {...}`` JSON line per run and a summary line; exits
non-zero without a card.

``--profile`` splits this checkout's K2 route (both shapes) and K6 (2^20)
into their device kernels under the profiler (device ms per call by
kernel name, over 20 calls), and times the stable ``torch.sort`` second
stage (``select_from_candidates``) on the same q candidates beside the
route's own rank sort.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def select_inputs(torch, cs, C, K, dev):
    """n and the main path's two selects as (name, rows, k): the smoke
    spec's 8 seed rows of one chunk plus one slab (k = 1025), and one row
    of compaction priorities of the same keys (k = capacity = 8201)."""
    from repro_torch.kernels.compact import retention_priority_plain
    rng = np.random.default_rng(1)
    spec = cs.smoke_spec(C, "ppswor")
    cap = spec.cap
    n = cs.CHUNK + cap
    keys = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, n).astype(
        np.int32)).to(dev)
    w = torch.from_numpy(rng.lognormal(0, 1.5, n).astype(np.float32)).to(dev)
    act = torch.from_numpy(rng.random(n) < 0.99).to(dev)
    seeds, _ = K.fused_seeds_fvals(keys, w, act, spec.kernel_objectives(),
                                   "ppswor", 17)
    member = torch.from_numpy(rng.random(n) < cap / n).to(dev)
    keep = member | torch.from_numpy(rng.random(n) < 8 / n).to(dev)
    pri = retention_priority_plain(torch.sort(keys).values, w, member,
                                   keep)[None, :]
    return n, (("k2_f8", seeds, 1025), ("k2_f1", pri, cap))


def kernel_split(torch, fn, calls: int = 20) -> dict:
    """Device ms per call of each kernel (and copy) ``fn`` runs, by name
    (its first 60 characters), and their total, under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {"total": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            ms = e.self_device_time_total / 1e3 / calls
            split[e.key[:60]] = split.get(e.key[:60], 0.0) + ms
            split["total"] += ms
    return {k: round(v, 4)
            for k, v in sorted(split.items(), key=lambda kv: -kv[1])}


def profile_tree() -> dict:
    """--profile: this checkout's K2 and K6 split into their kernels."""
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    import repro_torch.core as C
    import repro_torch.kernels as K
    from repro_torch.kernels.blockselect import select_from_candidates
    dev = torch.device("cuda")
    n, selects = select_inputs(torch, cs, C, K, dev)
    out = {}
    for name, s_in, k in selects:
        out[name] = kernel_split(torch, lambda: K.batched_bottomk_select(
            s_in, k))
        # the same q candidates in index order, sorted by torch.sort
        q = min(k + 1, n)
        pos = torch.sort(s_in, dim=1, stable=True).indices[:, :q]
        pos = torch.sort(pos, dim=1).values
        cv = torch.gather(s_in, 1, pos)
        ci = torch.where(torch.isfinite(cv), pos.to(torch.int32),
                         torch.full_like(pos, -1, dtype=torch.int32))
        out[f"{name}_torch_sort_stage_ms"] = cs.cuda_ms(
            torch, lambda: select_from_candidates(cv, ci, n, k))
    big = cs.capping_inputs(torch, C, dev, cs.UNIVERSAL_N, 7)
    out["k6"] = kernel_split(torch, lambda: K.rank_counts(*big))
    return out


def profiled_absorb(torch, cs, C, query_mod):
    """One warm absorb + drain under the profiler: (device ms, wall ms,
    {kernel name: device ms} of the five largest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    spec = cs.smoke_spec(C, "ppswor")
    eng = query_mod.SegmentQueryEngine(spec, shards=cs.SHARDS)
    rng = np.random.default_rng(100)
    for c in range(3):
        keys, w = cs.tenant_chunk(0, c, rng)
        eng.absorb(*C.quarantine_chunk(keys, w)[:3], shard=c % cs.SHARDS)
    eng.drain()
    keys, w = cs.tenant_chunk(0, 3, rng)
    k, ww, act, _ = C.quarantine_chunk(keys, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.absorb(k, ww, act, shard=3)
        eng.drain()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted(((e.key, e.self_device_time_total / 1e3)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    return (sum(t for _, t in ops), wall,
            {name[:48]: round(t, 4) for name, t in ops[:5]})


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
    n, selects = select_inputs(torch, cs, C, K, dev)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    out = dict(tree=str(tree), n=n)
    for name, s_in, k in selects:
        vals, idx, tau = K.batched_bottomk_select(s_in, k)
        out[f"{name}_check"] = [float(vals[torch.isfinite(vals)].double()
                                      .sum()), int(idx.sum()),
                                float(tau.double().sum())]
        out[f"{name}_ms"] = cs.cuda_ms(torch, lambda: K.batched_bottomk_select(
            s_in, k))
        out[f"{name}_cold_ms"] = cs.cuda_ms_cold(
            torch, lambda: K.batched_bottomk_select(s_in, k), flush)
        out[f"{name}_sort_ms"] = cs.cuda_ms(torch, lambda: torch.sort(
            s_in, dim=1, stable=True))
    big = cs.capping_inputs(torch, C, dev, cs.UNIVERSAL_N, 7)
    h, l = K.rank_counts(*big)
    out["k6_check"] = [int(h.double().sum()), int(l.double().sum())]
    out["k6_ms"] = cs.cuda_ms(torch, lambda: K.rank_counts(*big), reps=5,
                              inner=1)
    dev_ms, wall_ms, top = profiled_absorb(torch, cs, C, query_mod)
    out.update(absorb_device_ms=dev_ms, absorb_wall_ms=wall_ms,
               absorb_top=top)
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
        print("ab_k2k6: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if argv == ["--profile"]:
        print("PROFILE " + json.dumps(profile_tree()), flush=True)
        return 0
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
    keys = ("k2_f8_ms", "k2_f8_cold_ms", "k2_f8_sort_ms", "k2_f1_ms",
            "k2_f1_cold_ms", "k2_f1_sort_ms", "k6_ms", "absorb_device_ms",
            "absorb_wall_ms")
    print(json.dumps({label: {k: [r[k] for r in rs] for k in keys}
                      for label, rs in runs.items()}), flush=True)
    checks = {json.dumps([r[c] for c in ("k2_f8_check", "k2_f1_check",
                                         "k6_check")])
              for rs in runs.values() for r in rs}
    if len(checks) != 1:
        print(f"ab_k2k6: the trees' results differ: {checks}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
