"""The statistical-guarantee tier over the port: the paper's CV bounds,
seeded, as tests/test_statistical_guarantees.py asserts them for the JAX
package.

Thm 3.1 / §5.1: one multi-objective summary answers every f in F with the
per-objective CV guarantee of a dedicated bottom-k sample, cv(Q^(f, H))
<= sqrt(1 / (q (k_f - 1))) with q = Q(f, H) / Q(f, X). The reference
file's N, K, trial count, objective pool, schemes, |F| in {1, 3, 8} and
``CV_NOISE`` are imported from it; the port builds each trial's summary
through its runtime-seed path (``multi_sketch._build_body`` with
``seed``, the plain selection, on the CPU) and the assertions are the
reference's, per objective, per scheme and per |F|.

The CV bound alone would pass a port that is wrong but unbiased, so every
trial's estimates are also held against the reference's on the same seed
within ``tests/torch_parity.py``'s EST_RTOL (sums in another order over
probabilities within PROB_ULP).
"""
import functools

import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as TC
from repro_torch.core.multi_sketch import _build_body
from tests.test_statistical_guarantees import (CV_NOISE, K, N, TRIALS,
                                               _data, _pool,
                                               _trial_estimates)
from tests.torch_parity import EST_RTOL


def _port_pool():
    """The reference's objective pool, as the port's StatFns."""
    return [(TC.SUM, K), (TC.COUNT, K), (TC.thresh(3.0), K),
            (TC.cap(2.0), K), (TC.moment(1.5), K), (TC.thresh(0.8), K),
            (TC.cap(5.0), K), (TC.moment(0.7), K)]


_SINGLE = {"sum": 0, "count": 1, "thresh": 2, "cap": 3, "moment": 4}


@functools.lru_cache(maxsize=None)
def _estimates(scheme: str, picks: tuple):
    """(port [trials, |F|], reference [trials, |F|]) segment estimates of
    the summary over the pool's objectives ``picks``, trial t seeded t."""
    keys, w, act = _data()
    ref_spec = RC.MultiSketchSpec(objectives=tuple(
        _pool()[i] for i in picks), scheme=scheme, seed=0)
    spec = TC.MultiSketchSpec(objectives=tuple(
        _port_pool()[i] for i in picks), scheme=scheme, seed=0)
    tk, tw = torch.from_numpy(keys), torch.from_numpy(w)
    ta = torch.from_numpy(act)
    out = np.zeros((TRIALS, len(picks)), np.float64)
    for t in range(TRIALS):
        sk = _build_body(spec, tk, tw, ta, False, seed=t)
        segm = sk.keys % 3 == 0                    # the queried segment H
        for i, (f, _) in enumerate(spec.objectives):
            ht = torch.where(sk.member & segm, f(sk.weights)
                             / torch.clamp_min(sk.probs, 1e-30),
                             torch.zeros_like(sk.weights))
            out[t, i] = float(ht.sum())
    return out, _trial_estimates(ref_spec, keys, w, act)


def _check(scheme: str, picks: tuple):
    """The reference's ``_check_cv`` over the port's trials, and each
    trial's estimates against the reference's."""
    keys, w, act = _data()
    seg = keys % 3 == 0
    ests, ref = _estimates(scheme, picks)
    np.testing.assert_allclose(ests, ref, rtol=EST_RTOL)
    for i, (f, kf) in zip(range(len(picks)), (_port_pool()[j]
                                              for j in picks)):
        ex = float(TC.exact(f, w, act, seg, device="cpu"))
        q = ex / float(TC.exact(f, w, act, device="cpu"))
        cv = float(np.std(ests[:, i]) / ex)
        bound = TC.cv_bound(q, kf) * CV_NOISE
        assert cv <= bound, (f"{scheme} |F|={len(picks)} {f.name}: "
                             f"cv={cv:.3f} > bound={bound:.3f}")
        # unbiasedness (Eq. 5): the trial mean within the estimator's own
        # standard error of the exact value
        bias = abs(float(np.mean(ests[:, i])) - ex) / ex
        assert bias <= 3.0 * max(cv, 1e-3) / np.sqrt(TRIALS) + 1e-2, f.name


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("nf", [3, 8])
def test_cv_within_bound_multiobjective(scheme, nf):
    """cv <= bound for every objective of a shared |F|-objective summary."""
    _check(scheme, tuple(range(nf)))


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("kind", ["sum", "count", "thresh", "cap", "moment"])
def test_cv_within_bound_single_objective(scheme, kind):
    """|F| = 1: each StatFn family meets its dedicated-sample bound."""
    _check(scheme, (_SINGLE[kind],))


def test_multiobjective_cv_no_worse_than_dedicated():
    """Thm 3.1's other half: the shared summary's per-objective variance is
    no worse than a dedicated sample's, so growing F does not degrade an
    objective already in it (trial noise allowed, as the reference)."""
    keys, w, act = _data()
    seg = keys % 3 == 0
    ex = float(TC.exact(TC.SUM, w, act, seg, device="cpu"))
    cvs = {}
    for nf in (1, 8):
        ests, ref = _estimates("ppswor", tuple(range(nf)))
        np.testing.assert_allclose(ests, ref, rtol=EST_RTOL)
        cvs[nf] = float(np.std(ests[:, 0]) / ex)
    assert cvs[8] <= cvs[1] * 1.25, cvs
    assert N == 1200 and K == 32 and TRIALS == 200
