"""Parity of the port's core primitives (``repro_torch.core``) with the JAX
package's, on the same numpy inputs. Tolerances: tests/torch_parity.py."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as C                                        # noqa: E402
import repro_torch.core as T                                  # noqa: E402
from repro.core.predicates import hash31 as ref_hash31        # noqa: E402
from repro_torch import interop                               # noqa: E402
from tests.torch_parity import (EST_RTOL, FVAL_ULP, PROB_ULP,  # noqa: E402
                                SEED_ULP, assert_ulp, to_np)

ROOT = Path(__file__).resolve().parents[1]
_PAIRS = [(C.SUM, T.SUM), (C.COUNT, T.COUNT), (C.thresh(2.0), T.thresh(2.0)),
          (C.cap(1.5), T.cap(1.5)), (C.moment(1.5), T.moment(1.5)),
          (C.moment(0.5), T.moment(0.5))]


def _keys(rng, n, lo=-2 ** 31, hi=2 ** 31 - 1):
    return rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)


# ------------------------------------------------------------------ hashing
@pytest.mark.parametrize("seed", [0, 1, 17, 2 ** 31 - 1, 0xDEADBEEF])
def test_hash_u32_and_uniform01_bit_exact(seed):
    keys = _keys(np.random.default_rng(seed % 1000), 4096)   # negatives too
    ref = np.asarray(C.hash_u32(keys, np.uint32(seed))).astype(np.int64)
    port = to_np(T.hash_u32(torch.from_numpy(keys), seed))
    np.testing.assert_array_equal(ref, port)
    np.testing.assert_array_equal(np.asarray(C.uniform01(keys,
                                                         np.uint32(seed))),
                                  to_np(T.uniform01(keys, seed)))


def test_hash_broadcasts_tensor_seed_and_hash31_exact():
    rng = np.random.default_rng(3)
    keys = _keys(rng, 300)[None, :]
    salts = rng.integers(-2 ** 31, 2 ** 31 - 1, (16, 1)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(ref_hash31(keys, salts)),
        to_np(T.hash31(torch.from_numpy(keys), torch.from_numpy(salts))))


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
def test_rank_of_within_ulp(scheme):
    u = np.array(C.uniform01(np.arange(5000, dtype=np.int32), 5))
    assert_ulp(C.rank_of(u, scheme), T.rank_of(torch.from_numpy(u), scheme),
               SEED_ULP, scheme)


def test_rank_of_rejects_bogus_scheme():
    with pytest.raises(ValueError):
        T.rank_of(torch.zeros(3), "pps")


# ------------------------------------------------------------ funcs / seeds
@pytest.mark.parametrize("i", range(len(_PAIRS)),
                         ids=[p[0].name for p in _PAIRS])
def test_statfn_values(i):
    cf, tf = _PAIRS[i]
    w = np.random.default_rng(i).lognormal(0, 1.5, 3000).astype(np.float32)
    w[:50] = 0.0
    # (no denormals: XLA on the CPU flushes them to zero, PyTorch does not)
    w[50:60] = [2.0, 1.5, 0.5, 4.0, 1e-37, 1e-30, 1e30, 3.0, 1.0, 7.5]
    ref, port = np.asarray(cf(w)), to_np(tf(torch.from_numpy(w)))
    if cf.kind == "moment":
        assert_ulp(ref, port, FVAL_ULP, cf.name)
    else:
        np.testing.assert_array_equal(ref, port)
    assert tf.name == cf.name


def test_combo_statfn_and_name():
    cf = C.combo((0.5, C.SUM), (2.0, C.cap(1.5)))
    tf = T.combo((0.5, T.SUM), (2.0, T.cap(1.5)))
    w = np.random.default_rng(1).lognormal(0, 1, 500).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(cf(w)),
                                  to_np(tf(torch.from_numpy(w))))
    assert tf.name == cf.name and tf.is_monotone()
    with pytest.raises(ValueError):
        T.combo((-1.0, T.SUM))


def test_moment_pow_does_not_depend_on_batch_position():
    w = torch.from_numpy(np.random.default_rng(2).lognormal(
        0, 2, 10_007).astype(np.float32))
    full = T.moment(1.5)(w)
    for off in (1, 3, 7, 13, 31):
        assert torch.equal(T.moment(1.5)(w[off:].clone()), full[off:])


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("i", [0, 2, 4])
def test_f_seed_and_conditional_prob(scheme, i):
    cf, tf = _PAIRS[i]
    rng = np.random.default_rng(i)
    n = 2000
    keys = np.arange(n, dtype=np.int32)
    w = rng.lognormal(0, 1.5, n).astype(np.float32)
    act = rng.random(n) > 0.1
    u = np.array(C.uniform01(keys, 3))
    ref = C.f_seed(w, act, cf, u, scheme)
    port = T.f_seed(torch.from_numpy(w), torch.from_numpy(act), tf,
                    torch.from_numpy(u), scheme)
    assert_ulp(ref, port, SEED_ULP, "f_seed")
    fv = np.where(act, np.asarray(cf(w)), 0).astype(np.float32)
    tau = np.float32(np.sort(np.asarray(ref))[40])
    for t in (tau, np.float32(np.inf)):
        assert_ulp(C.conditional_prob(fv, t, scheme),
                   T.conditional_prob(torch.from_numpy(fv),
                                      torch.tensor(t), scheme), PROB_ULP,
                   "prob")


@pytest.mark.parametrize("k", [1, 5, 64, 300])
def test_kth_and_tau(k):
    x = np.random.default_rng(k).random((3, 300)).astype(np.float32)
    x[1, :10] = 0.25                                   # ties
    kth_r, tau_r = C.bottomk.kth_and_tau(x, k)
    kth_p, tau_p = T.kth_and_tau(torch.from_numpy(x), k)
    np.testing.assert_array_equal(np.asarray(kth_r), to_np(kth_p))
    np.testing.assert_array_equal(np.asarray(tau_r), to_np(tau_p))


# --------------------------------------------------------------- predicates
def _preds(mod):
    return [mod.EVERYTHING, mod.key_range(100, 5000), mod.key_range(7, 7),
            mod.key_mask(3, 1), mod.key_mask(0xF0, 0x30),
            mod.hash_fraction(0.25, 3), mod.hash_fraction(0.9, 0),
            mod.hash_fraction(0.0), mod.SegmentPredicate(
                lo=10, hi=90_000, mask=1, want=0, salt=5, on_hash=False)]


def test_predicate_wire_rows_and_table_helpers():
    ref = C.encode_predicates(_preds(C))
    port = T.encode_predicates(_preds(T))
    np.testing.assert_array_equal(ref, port)
    np.testing.assert_array_equal(T.encode_predicates(port), port)
    np.testing.assert_array_equal(
        T.encode_predicates(torch.from_numpy(port)), port)
    padded = T.pad_table(port, 16)
    assert padded.shape == (16, 6)
    np.testing.assert_array_equal(padded[len(port):],
                                  np.tile(T.never_row(), (16 - len(port), 1)))
    with pytest.raises(ValueError):
        T.encode_predicates([])
    with pytest.raises(ValueError):
        T.encode_predicates(np.zeros((2, 5), np.int32))
    with pytest.raises(ValueError):
        T.hash_fraction(1.5)


def test_predicate_matrix_exact():
    rng = np.random.default_rng(4)
    keys = np.concatenate([rng.integers(0, 100_000, 997),
                           [-1, -1, 0, 7]]).astype(np.int32)
    table = C.encode_predicates(_preds(C))
    np.testing.assert_array_equal(
        np.asarray(C.predicate_matrix(keys, table)),
        to_np(T.predicate_matrix(torch.from_numpy(keys), table)))
    np.testing.assert_array_equal(
        np.asarray(C.key_range(100, 5000)(keys)),
        to_np(T.key_range(100, 5000)(torch.from_numpy(keys))))


# --------------------------------------------------------------- estimators
@pytest.mark.parametrize("b", [1, 16, 128])
def test_estimate_many_within_rtol(b):
    rng = np.random.default_rng(b)
    n = 400
    keys = rng.integers(0, 50_000, n).astype(np.int32)
    w = rng.lognormal(0, 1.5, n).astype(np.float32)
    p = rng.uniform(0.01, 1.0, n).astype(np.float32)
    m = rng.random(n) < 0.7
    table = C.encode_predicates(
        [C.key_range(int(lo), int(lo) + 20_000)
         for lo in rng.integers(0, 30_000, b)])
    fs_c = [f for f, _ in _PAIRS]
    fs_t = [f for _, f in _PAIRS]
    ref = C.estimate_many(fs_c, w, p, m, C.predicate_matrix(keys, table))
    port = T.estimate_many(fs_t, torch.from_numpy(w), torch.from_numpy(p),
                           torch.from_numpy(m),
                           T.predicate_matrix(torch.from_numpy(keys), table))
    np.testing.assert_allclose(to_np(port), np.asarray(ref), rtol=EST_RTOL)
    # each answer's bits do not depend on its batch
    one = T.estimate_many(fs_t, torch.from_numpy(w), torch.from_numpy(p),
                          torch.from_numpy(m), T.predicate_matrix(
                              torch.from_numpy(keys), table[:1]))
    assert torch.equal(one[:, 0], port[:, 0])


@pytest.mark.parametrize("q,k,rho", [(1.0, 1024, 1.0), (0.1, 64, 2.5),
                                     (1e-40, 1, 1.0)])
def test_cv_bound(q, k, rho):
    np.testing.assert_allclose(T.cv_bound(q, k, rho), C.cv_bound(q, k, rho),
                               rtol=1e-6)


# ------------------------------------------------------------------ interop
def test_interop_roundtrip_exact():
    spec = C.MultiSketchSpec(((C.SUM, 8), (C.moment(1.5), 4)))
    rng = np.random.default_rng(0)
    ref = C.multisketch_build(spec, np.arange(300, dtype=np.int32),
                              rng.lognormal(0, 1, 300).astype(np.float32))
    port = interop.from_arrays([np.asarray(x) for x in ref], device="cpu")
    assert port.keys.dtype == torch.int32 and port.member.dtype == torch.bool
    back = interop.to_arrays(port)
    for name, x, y in zip(ref._fields, ref, back):
        np.testing.assert_array_equal(np.asarray(x), y, err_msg=name)
        assert np.asarray(x).dtype == y.dtype
    with pytest.raises(ValueError):
        interop.from_arrays(back[:7], device="cpu")


# ------------------------------------------------------- package boundaries
_HYGIENE = """
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
"""


def test_import_hygiene_no_jax_no_reference():
    code = _HYGIENE.format(src=str(ROOT / "src"), root=str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_cpu_fallback_without_a_card(monkeypatch):
    from repro_torch.launch.pool import EnginePool
    from repro_torch.launch.query import SegmentQueryEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = T.MultiSketchSpec(((T.SUM, 4),))
    with pytest.raises(RuntimeError, match="CUDA"):
        EnginePool()
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentQueryEngine(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.multisketch_empty(spec)


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, env=env, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
