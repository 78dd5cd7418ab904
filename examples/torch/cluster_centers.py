"""Sample-based center optimization over a metric point set on the port
(paper §7; the twin of ``examples/cluster_centers.py``).

    PYTHONPATH=src python examples/torch/cluster_centers.py [--points N] [--device cpu]

Builds a ``ClusterEngine`` over a synthetic Gaussian mixture (the
reference script's points: numpy's generator at seed 0) — a resident
sampled point slab whose probabilities universally upper-bound every
center-set objective — then optimizes centers from the sample alone:
every local-search round scores all candidate swaps in one service-cost
launch (K5), and the result is cross-checked against ground-truth costs
over the full point set. Runs on the CUDA card unless ``--device cpu``.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.costs import cost_query, exact_service_costs
from repro_torch.launch.cluster import (ClusterEngine, exact_scorer, kcenter,
                                        local_search)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=4000,
                    help="mixture size (fewer for a short run)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    true_centers = np.array([[0., 0.], [9., 1.], [4., 8.], [-6., 6.]],
                            np.float32)
    n = args.points
    X = (true_centers[rng.integers(0, 4, n)]
         + rng.normal(0, 0.8, (n, 2))).astype(np.float32)

    # stream the points in chunks: the engine's resident slab absorbs each
    # with the device fold and stays a few hundred slots in all
    eng = ClusterEngine(dim=2, k=96, mu=2.0, seed=0, device=dev)
    for chunk in np.array_split(X, 8):
        eng.absorb(chunk)
    print(f"absorbed n={len(X)} in 8 chunks; "
          f"slab members={int(eng.sample()[2].sum())}, "
          f"HT count estimate={eng.total_count():.0f}")

    for mu, name in ((2.0, "k-means"), (1.0, "k-median")):
        res = local_search(eng, k=4, mu=mu, rounds=16, n_cand=32)
        exact = float(exact_service_costs(X, cost_query(res.centers, mu),
                                          device=dev)[0])
        ref = local_search(eng, k=4, mu=mu, rounds=16, n_cand=32,
                           scorer=exact_scorer(X, device=dev))
        ref_cost = float(exact_service_costs(
            X, cost_query(ref.centers, mu), device=dev)[0])
        print(f"[{name}] centers:\n{np.round(res.centers, 2)}")
        print(f"[{name}] est cost {res.est_cost:.1f} | exact cost of result "
              f"{exact:.1f} | exact-scored search {ref_cost:.1f} "
              f"(ratio {exact / ref_cost:.3f}) | rounds {res.rounds}")

    kc = kcenter(eng, 4)
    print(f"[k-center] radius {kc.radius:.2f}; estimated coverage "
          f"{kc.coverage_est:.0f} of {kc.total_est:.0f}")


if __name__ == "__main__":
    main()
