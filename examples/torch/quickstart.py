"""Quickstart on the port: multi-objective weighted sampling of a keyed
data set (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py [--keys N] [--device cpu]

One universal monotone sample of an N-key data set (100,000 by default)
answers many segment f-statistics — count, sum, thresholds, caps,
moments — each within the paper's CV bound 1/sqrt(q(k-1)) (Thm 5.1,
§5.1); then 16 shard sketches merge into one that estimates as the
centralized sample does. The data are the reference script's (numpy's
generator at seed 0); everything else runs in ``repro_torch``, on the
CUDA card unless ``--device cpu``.
"""
import argparse

import numpy as np

import repro_torch.core as C
from repro_torch import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=100_000,
                    help="data set size (fewer for a short run)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n, k = args.keys, 64

    # a keyed data set: per-user activity with heavy-tailed weights
    keys = np.arange(n, dtype=np.int32)
    weights = rng.lognormal(0.0, 2.0, n).astype(np.float32)
    active = np.ones(n, bool)
    domain = rng.integers(0, 8, n)  # segment attribute

    # ---- ONE sample serves all monotone statistics -----------------------
    sample = C.universal_monotone_sample(keys, weights, active, k, seed=42,
                                         device=dev)
    print(f"sample size: {int(sample.member.sum())} of {n} keys "
          f"(bound k ln n = {C.expected_size_bound(n, k):.0f})")

    segment = domain == 3
    for f in [C.COUNT, C.SUM, C.thresh(5.0), C.cap(2.0), C.moment(1.5)]:
        est = float(C.estimate(f, weights, sample.prob, sample.member,
                               segment))
        exact = float(C.exact(f, weights, active, segment, device=dev))
        q = exact / float(C.exact(f, weights, active, device=dev))
        print(f"  Q({f.name:10s}, domain=3): est {est:12.1f}   "
              f"exact {exact:12.1f}   err {abs(est / exact - 1) * 100:5.1f}%"
              f"   CV bound {C.cv_bound(q, k) * 100:.1f}%")

    # ---- mergeability: shard the data, sketch each shard, merge ----------
    cap_sz = C.sketch_capacity(n, k)
    parts = np.array_split(np.arange(n), 16)
    sketches = [C.build_sketch(keys[p], weights[p], active[p], k, cap_sz,
                               seed=42, device=dev) for p in parts]
    merged = sketches[0]
    for s in sketches[1:]:
        merged = C.merge_sketches(merged, s)
    print(f"merged-sketch sum estimate: "
          f"{float(C.sketch_estimate(merged, C.SUM)):.1f}  "
          f"(exact {weights.sum():.1f}) — distributed == centralized")


if __name__ == "__main__":
    main()
