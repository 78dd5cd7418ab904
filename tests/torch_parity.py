"""Field rules shared by the parity tests of the PyTorch port.

The same numpy inputs go through the JAX package and the port; results are
held to these tolerances:

  * exact: keys, member, aux, valid, selected idx, take, weights, the hash,
    u and hash31 (integer, boolean, or exact by construction);
  * ulp bounds for fields that pass through log1p, expm1 or pow, because
    XLA on the CPU and PyTorch round the last bits differently. Measured
    on the CPU over dense grids: XLA's float32 log1p is up to 1.6 ulp from
    the correctly rounded value, its pow up to ~2 ulp, its expm1 up to
    5.0 ulp (arguments in [1e-4, 0.5]); PyTorch's are within 0.6 ulp. So r
    differs by up to 2 ulp, and the seed r / f(w) keeps that relative error,
    which is up to 4 ulp of a quotient that lands in a lower binade
    (measured: 4 ulp over 200k keys). Hence seeds and taus <= 4 ulp,
    moment f-values <= 2 ulp, probs <= 12 ulp (expm1's 5 on top of a
    4-ulp tau, doubled at a binade edge, rounded up);
  * rtol 1e-5 for estimates (sums taken in another order);
  * within the port: bit-identical.

The metric tier (service costs, anchors) adds, measured on the CPU against
XLA's float32 ops:

  * squared distances |x|^2 + |c|^2 - 2 x.c: the expansion cancels, so the
    error is absolute, in units of the scale |x|^2 + |c|^2. XLA's and
    PyTorch's sq_dists agree bitwise in only about half the entries; the
    largest gap measured was 3.3 eps32 of the scale (dim 2, 3 and 68,
    6 seeds; 4 ulp of |x|^2 in a probe at |x|^2 ~ 4277). Hence
    |d2_ref - d2_port| <= SQDIST_EPS * eps32 * (|x|^2 + |c|^2), and through
    the sqrt a distance within sqrt of that;
  * pow at a run-time exponent (d^mu = powf(d2, mu / 2)): XLA's float32 pow
    against PyTorch's float64 pow rounded once, 200k arguments in
    [1e-3, 5e3] at mu in {1, 1.5, 2, 3}: at most 1 ulp (99.93 % equal at
    mu = 1.5, bitwise at mu = 2); XLA's pow was measured up to ~2 ulp from
    the correctly rounded value, hence POW_ULP = 2;
  * ball mode (1[d2 <= r^2]): a slot may flip only when its d2 lies within
    the sq_dists tolerance of r^2, so an estimate may differ by at most
    the HT weights of exactly those slots (``ball_flip_bound``);
  * anchor weights (mean, column sums and a max of quotients over n rows,
    summed in another order): over 5 seeds x mu in {1, 1.5, 2}, eps within
    1 ulp, the per-anchor norms 2 ulp, v 4 ulp; the bounds are those maxima
    rounded up: ANCHOR_EPS_ULP 2, ANCHOR_NORM_ULP 4, ANCHOR_V_ULP 6;
  * a ClusterEngine slab's weights ARE those v, so its seeds r / v, taus
    and probs carry v's ulps on top of their own bounds
    (``assert_metric_slab_parity``); measured over 3 absorbs x 2 schemes x
    mu in {1, 2}: weights 3, seeds 4, taus 2, probs 4 ulp.

The universal tier adds:

  * the universal monotone sample, its scan and sketches depend on u and
    w alone, which are exact, so member, aux, h, prob (a u value) and
    every Sketch field are held exactly;
  * pps probabilities k f(w) / sum f(w) share a sum taken in another
    order: EST_RTOL (measured 3 ulp over 400 keys), and membership u < p
    is exact for keys whose u is not within that window of p;
  * the capping sample's l counts compare r/w across keys, and under
    ppswor r/w is a seed (<= SEED_ULP from XLA's). Two keys can swap
    order only when their r/w lie within 2 * SEED_ULP ulp of each other,
    so the integer fields are exact whenever no two active keys do
    (``rw_gap_ok``, asserted by the tests as a precondition, never a
    looser comparison); capping probs -expm1(-w t) within PROB_ULP
    (measured 3).
"""
from __future__ import annotations

import numpy as np

SEED_ULP = 4
FVAL_ULP = 2
PROB_ULP = 12
EST_RTOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
SQDIST_EPS = 8
POW_ULP = 2
ANCHOR_EPS_ULP = 2
ANCHOR_NORM_ULP = 4
ANCHOR_V_ULP = 6


def to_np(x) -> np.ndarray:
    """A JAX array, a torch tensor or a numpy array -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ulp_dist(a, b) -> int:
    """Largest ulp distance between two float32 arrays; non-finite entries
    must agree exactly."""
    a = np.asarray(to_np(a), np.float32)
    b = np.asarray(to_np(b), np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    fa, fb = np.isfinite(a), np.isfinite(b)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(a[~fa], b[~fb])
    if not fa.any():
        return 0
    ia = a[fa].view(np.int32).astype(np.int64)
    ib = b[fb].view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def assert_ulp(a, b, bound: int, what: str = ""):
    d = ulp_dist(a, b)
    assert d <= bound, f"{what}: {d} ulp > {bound}"


def assert_slab_parity(ref, port, what: str = ""):
    """A reference MultiSketch against the port's, field by field."""
    for name in ("keys", "member", "aux", "valid", "weights"):
        np.testing.assert_array_equal(to_np(getattr(ref, name)),
                                      to_np(getattr(port, name)),
                                      err_msg=f"{what}{name}")
    assert_ulp(ref.seeds, port.seeds, SEED_ULP, f"{what}seeds")
    assert_ulp(ref.taus, port.taus, SEED_ULP, f"{what}taus")
    assert_ulp(ref.probs, port.probs, PROB_ULP, f"{what}probs")


def assert_slabs_bitsame(a, b, what: str = ""):
    """Two of the port's slabs, all 8 fields bit for bit."""
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(to_np(x), to_np(y),
                                      err_msg=f"{what}{name}")


def sq_dist_tol(centers, points) -> np.ndarray:
    """[m, c] absolute bound on |d2_ref - d2_port|:
    SQDIST_EPS * eps32 * (|c|^2 + |x|^2), in float64."""
    c = np.asarray(to_np(centers), np.float64)
    x = np.asarray(to_np(points), np.float64)
    return SQDIST_EPS * EPS32 * ((c * c).sum(1)[:, None]
                                 + (x * x).sum(1)[None, :])


def exact_sq_dists(centers, points) -> np.ndarray:
    """[m, c] squared distances in float64 (the value both float32 sides
    approximate)."""
    c = np.asarray(to_np(centers), np.float64)
    x = np.asarray(to_np(points), np.float64)
    return ((c[:, None, :] - x[None, :, :]) ** 2).sum(-1)


def ball_flip_bound(points, probs, member, centers, cvalid, radius,
                    point_weights=None) -> float:
    """The most a ball-mode estimate may move between two float32 paths:
    the HT weights of the member slots whose d2 to the set (min over its
    valid centers) lies within the sq_dists tolerance of r^2."""
    ctr = np.asarray(to_np(centers), np.float32)[np.asarray(to_np(cvalid),
                                                            bool)]
    if ctr.shape[0] == 0:
        return 0.0
    mind2 = exact_sq_dists(ctr, points).min(0)
    tol = sq_dist_tol(ctr, points).max(0)
    near = np.abs(mind2 - float(radius) ** 2) <= tol
    p = np.asarray(to_np(probs), np.float64)
    pw = (np.ones_like(p) if point_weights is None
          else np.asarray(to_np(point_weights), np.float64))
    ht = np.where(np.asarray(to_np(member), bool),
                  pw / np.maximum(p, 1e-30), 0.0)
    return float(ht[near].sum())


def assert_metric_slab_parity(ref, port, what: str = ""):
    """A reference ClusterEngine slab against the port's: integer and
    boolean fields exact; the weights (anchor weights v) within
    ANCHOR_V_ULP, and the fields derived from them within their own bounds
    plus ANCHOR_V_ULP."""
    for name in ("keys", "member", "aux", "valid"):
        np.testing.assert_array_equal(to_np(getattr(ref, name)),
                                      to_np(getattr(port, name)),
                                      err_msg=f"{what}{name}")
    assert_ulp(ref.weights, port.weights, ANCHOR_V_ULP, f"{what}weights")
    assert_ulp(ref.seeds, port.seeds, SEED_ULP + ANCHOR_V_ULP,
               f"{what}seeds")
    assert_ulp(ref.taus, port.taus, SEED_ULP + ANCHOR_V_ULP, f"{what}taus")
    assert_ulp(ref.probs, port.probs, PROB_ULP + ANCHOR_V_ULP,
               f"{what}probs")


def rw_gap_ok(r, w, active) -> bool:
    """True when no two active keys' r / w (float32) lie within
    2 * SEED_ULP ulp of each other, so their order is the same on both
    sides of a ppswor parity test."""
    rw = (np.asarray(r, np.float32)
          / np.asarray(w, np.float32))[np.asarray(active, bool)]
    iv = np.sort(rw).view(np.int32).astype(np.int64)
    return bool(np.all(np.diff(iv) > 2 * SEED_ULP))
