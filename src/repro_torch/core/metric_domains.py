"""Metric-domain universal samples (paper §7).

Port of ``repro/core/metric_domains.py``. For points X in a metric space
and query-indexed objectives f_q(x) = d(q, x)^mu (centrality) and
f_{q,r}(x) = 1[d(q, x) <= r] (ball density), anchor-based upper-bound
probabilities p_x = min(1, 2^mu k max_a p̄_x^{(a)}) give one sample that
serves every query q (Chechik-Cohen-Kaplan). The sample is a ``MultiSketch``:
the probabilities are the WEIGHTS of a (SUM, k_eff) bottom-k build with
k_eff = ceil(sum_x p_x), so it inherits absorb, merge and the service-cost
kernel (through ``launch.cluster.ClusterEngine``).

Anchors come from a farthest-point traversal whose argmax stays a device
tensor: no host round trip per anchor. ``torch.argmax``, like
``jnp.argmax``, returns the first maximal index.

Host inputs go to ``device`` (default the card); tensors stay where they
are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from .costs import points_to, sq_dists
from .funcs import SUM, powf
from .multi_sketch import MultiSketch, MultiSketchSpec, multisketch_build


class MetricSample(NamedTuple):
    member: torch.Tensor   # bool [n]
    prob: torch.Tensor     # float32 [n]: conditional HT probabilities
    anchors: torch.Tensor  # int32 [m]: anchor indices


class MetricSketch(NamedTuple):
    """Slab-format metric sample: the sketch plus the coordinates of its
    slots, everything the service-cost kernel consumes."""
    sketch: MultiSketch    # slab over keys = point indices
    coords: torch.Tensor   # float32 [cap, dim]: X[key] per slot (0 invalid)
    anchors: torch.Tensor  # int32 [m]


def _pairwise_dist(X, Y) -> torch.Tensor:
    # the quadratic-expansion distance of the cost path: anchors, probs and
    # service costs never diverge on clamping
    return torch.sqrt(sq_dists(X, Y))


def farthest_point_anchors(X, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy 2-approx k-center net (farthest-point traversal) from point 0.

    Returns (anchors int32 [m], d_min float32 [n] = distance to the nearest
    anchor). Each step's argmax stays on the device.
    """
    X = points_to(X)
    d_min = _pairwise_dist(X, X[:1]).reshape(-1)
    anchors = torch.zeros((m,), dtype=torch.int32, device=X.device)
    for j in range(1, m):
        nxt = torch.argmax(d_min)
        d_min = torch.minimum(d_min, _pairwise_dist(
            X, X.index_select(0, nxt.reshape(1))).reshape(-1))
        anchors[j] = nxt
    return anchors, d_min


def anchor_upper_weights(X, anchor_coords, mu: float, eps=None, norm=None):
    """Per-point universal upper-bound weights v_x = max_a p̄_x^{(a)}.

    For each anchor a, p̄^{(a)} is the pps distribution of
    f_a(x) = (d(a, x) + eps)^mu. ``eps``/``norm`` ([m] per-anchor column
    sums) default to this batch's own statistics; a streaming caller
    (launch.cluster) freezes them at the first chunk so weights stay
    comparable across chunks.

    Returns (v [n], eps, norm).
    """
    X = points_to(X)
    D = _pairwise_dist(X, points_to(anchor_coords, X.device))    # [n, m]
    if eps is None:
        eps = torch.mean(D) * 1e-3 + 1e-12
    fv = powf(D + eps, mu)
    if norm is None:
        norm = torch.sum(fv, dim=0)
    v = torch.amax(fv / norm[None, :], dim=1)
    return v, eps, norm


def metric_sample_sketch(X, k: int, mu: float = 1.0, n_anchors: int = 8,
                         seed: int = 0, scheme: str = "ppswor", device=None
                         ) -> Tuple[MetricSketch, MultiSketchSpec]:
    """One slab serving f_q(x) = d(q, x)^mu for ALL queries q.

    The anchor-based probabilities p_x = min(1, 2^mu k v_x) become the
    weights of a (SUM, k_eff) bottom-k MultiSketch with
    k_eff = ceil(sum p_x), built with the run-time hash seed (the plain
    selection path, as in the reference).
    """
    X = points_to(X, device)
    n = X.shape[0]
    anchors, _ = farthest_point_anchors(X, min(n_anchors, n))
    v, _, _ = anchor_upper_weights(X, X[anchors.long()], mu)
    p_t = torch.clamp_max((2.0 ** mu) * k * v, 1.0)
    k_eff = max(2, int(math.ceil(float(torch.sum(p_t)))))
    spec = MultiSketchSpec(objectives=((SUM, k_eff),), scheme=scheme,
                           seed=seed)
    sk = multisketch_build(dataclasses.replace(spec, seed=0),
                           torch.arange(n, dtype=torch.int32,
                                        device=X.device), p_t, seed=seed)
    slot = torch.clamp(sk.keys, 0, n - 1).long()
    coords = torch.where(sk.valid[:, None], X[slot], torch.zeros_like(
        X[slot]))
    return MetricSketch(sketch=sk, coords=coords, anchors=anchors), spec


def universal_metric_sample(X, k: int, mu: float = 1.0, n_anchors: int = 8,
                            seed: int = 0, device=None) -> MetricSample:
    """Dense-mask view of :func:`metric_sample_sketch` (classic §7 API):
    member/prob scattered from the slab back over the n points."""
    X = points_to(X, device)
    n = X.shape[0]
    ms, _ = metric_sample_sketch(X, k, mu=mu, n_anchors=n_anchors, seed=seed)
    sk = ms.sketch
    # slots that are not valid members land in a spare slot n, cut away
    at = torch.where(sk.valid & sk.member, sk.keys,
                     torch.full_like(sk.keys, n)).long()
    member = torch.zeros((n + 1,), dtype=torch.bool, device=X.device)
    member[at] = True
    prob = torch.zeros((n + 1,), dtype=torch.float32, device=X.device)
    prob[at] = sk.probs
    return MetricSample(member=member[:n], prob=prob[:n], anchors=ms.anchors)


def estimate_centrality(sample: MetricSample, X, q, mu: float = 1.0):
    """HT estimate of sum_x d(q, x)^mu from the universal sample."""
    X = points_to(X, sample.member.device)
    q = points_to(q, X.device).reshape(1, -1)
    d = _pairwise_dist(X, q).reshape(-1)
    contrib = torch.where(sample.member,
                          powf(d, mu) / torch.clamp_min(sample.prob, 1e-30),
                          torch.zeros_like(d))
    return torch.sum(contrib)


def estimate_ball_density(sample: MetricSample, X, q, r: float):
    """HT estimate of |{x : d(q, x) <= r}| from the same sample."""
    X = points_to(X, sample.member.device)
    q = points_to(q, X.device).reshape(1, -1)
    d = _pairwise_dist(X, q).reshape(-1)
    contrib = torch.where(sample.member & (d <= r),
                          1.0 / torch.clamp_min(sample.prob, 1e-30),
                          torch.zeros_like(d))
    return torch.sum(contrib)
