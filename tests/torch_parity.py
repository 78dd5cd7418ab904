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
"""
from __future__ import annotations

import numpy as np

SEED_ULP = 4
FVAL_ULP = 2
PROB_ULP = 12
EST_RTOL = 1e-5


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
