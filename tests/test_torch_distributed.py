"""The port's distributed paths across 4 CPU processes over gloo (one spawn
for the module): the sharded MultiSketch builds (mirrors
tests/test_multisketch.py::test_sharded_build_matches_one_shot_multidevice
and tests/test_query_engine.py::
test_engine_from_sharded_matches_eager_multidevice), the 2-pod sampled
gradient exchange against the reference's formula applied to the JAX
package's own ``_sample_leaf`` slabs, and 6 steps of training on a
(pod 2, data 2, model 1) mesh held to the thresholds of
tests/test_distribution.py (which fails on the reference under JAX 0.9.0).

Tolerances: the sharded builds' member keys exact against the reference's
one-shot sample, probs within 1e-5 and taus rtol 1e-6 (the reference's own
bars), and bit-identical to the port's one-shot build and across ranks;
the exchanged gradients rtol 1e-5 / atol 1e-7 against the formula on the
reference's slabs (their probs differ by up to PROB_ULP).
"""
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as C
from repro.distopt import compression as RC
import repro_torch.core as T
from repro_torch import interop

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
N = 4096
# the objective lists, shared verbatim with the worker script
_OBJS_SRC = """
def objs(M, nf):
    return {1: ((M.SUM, 16),),
            3: ((M.SUM, 16), (M.COUNT, 8), (M.thresh(2.0), 12)),
            8: ((M.SUM, 8), (M.COUNT, 8), (M.thresh(2.0), 8),
                (M.cap(1.5), 8), (M.moment(1.5), 8), (M.thresh(0.5), 8),
                (M.cap(4.0), 8), (M.moment(0.5), 8))}[nf]
"""
exec(_OBJS_SRC)
NFS = (1, 3, 8)
EX_N, EX_K, EX_STEP = 20_000, 64, 5

_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    import repro_torch.core as T
    from repro_torch import interop
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distopt.compression import exchange_grads
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.query import SegmentQueryEngine
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.summary import (sharded_multisketch,
                                            sharded_multisketch_shards)
    from repro_torch.models.model import init_model
    from repro_torch.optim import adamw

    @OBJS_SRC@
    res = {}
    rng = np.random.default_rng(4)
    n = @N@
    keys = rng.permutation(np.arange(n)).astype(np.int32)
    w = rng.lognormal(0, 1.5, n).astype(np.float32)
    mesh4 = Mesh((world,), ("data",), device="cpu")
    for nf in (1, 3, 8):
        spec = T.MultiSketchSpec(objectives=objs(T, nf), seed=13)
        res[f"build{nf}"] = interop.to_arrays(
            sharded_multisketch(spec, mesh4, keys, w))
    spec = T.MultiSketchSpec(objectives=objs(T, 3), seed=13)
    eager = sharded_multisketch(spec, mesh4, keys, w)
    eng = SegmentQueryEngine.from_sharded(spec, mesh4, keys, w)
    res["lazy_same"] = all(bool(torch.equal(a, b))
                           for a, b in zip(eng.merged, eager))
    res["est"] = eng.query_many(predicates=[T.EVERYTHING,
                                            T.key_range(0, n // 2 - 1)])
    res["stacked"] = interop.to_arrays(
        sharded_multisketch_shards(spec, mesh4, keys, w))

    # the 2-pod exchange: pod p's gradient is drawn from seed p
    mesh = Mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    pod = mesh.coords["pod"]
    g = np.random.default_rng(pod).standard_normal(@EX_N@).astype(
        np.float32)
    g[np.random.default_rng(10 + pod).random(@EX_N@) < 0.1] = 0.0
    small = np.full(100, float(pod + 1), np.float32)
    res["pod"] = pod
    res["exchange"] = {k: v.numpy() for k, v in exchange_grads(
        mesh, {"big": torch.from_numpy(g.reshape(200, 100)),
               "small": torch.from_numpy(small)}, @EX_STEP@, k=@EX_K@,
        min_size=1024).items()}

    # 6 steps on the (2, 2, 1) mesh, the reference test's settings
    cfg = get_smoke_config("qwen2-1.5b")
    params, _ = init_model(cfg, seed=0, device="cpu")
    opt = adamw.OptConfig(total_steps=50, warmup_steps=2, peak_lr=5e-3)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 32))
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32))}
    for name, kw, steps in (("dense", {}, 6),
                            ("compressed",
                             {"compress": dict(k=512, min_size=1024)}, 6),
                            ("microbatch", {"microbatch": 2}, 1)):
        step, _ = make_train_step(cfg, opt, mesh, **kw)
        st = {"params": params, "opt": adamw.init_opt_state(params)}
        losses = []
        for _ in range(steps):
            st, m = step(st, batch)
            losses.append(float(m["loss"]))
        res[name] = losses

    # train.main on the same mesh: rank 0 writes the checkpoints
    from repro_torch.launch import train
    st = train.main(["--device", "cpu", "--smoke", "--steps", "2",
                     "--batch", "8", "--seq", "32", "--mesh", "2x2x1",
                     "--compress", "--ckpt-dir", f"{out}/ck", "--log-every",
                     "5"])
    res["main_step"] = int(st["opt"]["step"])
    dist.barrier()
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
""")
for _k, _v in (("@OBJS_SRC@", textwrap.indent(_OBJS_SRC, "    ").strip()),
               ("@N@", str(N)), ("@EX_N@", str(EX_N)), ("@EX_K@", str(EX_K)),
               ("@EX_STEP@", str(EX_STEP))):
    _WORKER = _WORKER.replace(_k, _v)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(WORLD), port, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        e[-3000:] for e in errs)
    res = [pickle.load(open(out / f"rank{r}.pkl", "rb"))
           for r in range(WORLD)]
    for r in res:
        r["dir"] = out
    return res


def _inputs():
    rng = np.random.default_rng(4)
    keys = rng.permutation(np.arange(N)).astype(np.int32)
    w = rng.lognormal(0, 1.5, N).astype(np.float32)
    return keys, w


@pytest.mark.parametrize("nf", NFS)
def test_sharded_build_matches_one_shot(ranks, nf):
    keys, w = _inputs()
    got = ranks[0][f"build{nf}"]
    for r in ranks[1:]:
        for a, b in zip(got, r[f"build{nf}"]):
            np.testing.assert_array_equal(a, b)
    sk = T.MultiSketch(*(torch.from_numpy(x) for x in got))
    ref = C.multi_bottomk_sample(keys, w, np.ones(N, bool), objs(C, nf),
                                 scheme="ppswor", seed=13)
    m = got[4]
    have = dict(zip(got[0][m].tolist(), got[2][m].tolist()))
    rm = np.asarray(ref.member)
    want = dict(zip(keys[rm].tolist(), np.asarray(ref.prob)[rm].tolist()))
    assert set(have) == set(want)
    assert all(abs(have[k] - want[k]) < 1e-5 for k in want)
    np.testing.assert_allclose(got[7], np.asarray(ref.taus), rtol=1e-6)
    # and the port's own one-shot build over the whole data, bit for bit
    spec = T.MultiSketchSpec(objectives=objs(T, nf), seed=13)
    one = T.multisketch_build(spec, keys, w, device="cpu")
    def triples(s):
        mm = s.member & s.valid
        return sorted(zip(s.keys[mm].tolist(), s.weights[mm].tolist(),
                          s.probs[mm].tolist()))
    assert triples(sk) == triples(one)
    assert torch.equal(sk.taus, one.taus)


def test_from_sharded_matches_the_eager_build(ranks):
    keys, w = _inputs()
    for r in ranks:
        assert r["lazy_same"]
        assert abs(r["est"][0, 0] / w.sum() - 1) < 0.5
    stacked = ranks[0]["stacked"]
    assert stacked[0].shape[0] == WORLD
    for r in ranks[1:]:
        for a, b in zip(stacked, r["stacked"]):
            np.testing.assert_array_equal(a, b)
    # merging the stacked rows reproduces the eager build
    spec = T.MultiSketchSpec(objectives=objs(T, 3), seed=13)
    merged = T.multisketch_merge_stacked(
        spec, T.MultiSketch(*(torch.from_numpy(x) for x in stacked)),
        use_kernels=True)
    for a, b in zip(interop.to_arrays(merged), ranks[0]["build3"]):
        np.testing.assert_array_equal(a, b)


def _reference_exchange(pod_of_rank):
    """(total - est_self + own_g) / 2 on the JAX package's slabs."""
    grads, slabs = [], []
    for pod in (0, 1):
        g = np.random.default_rng(pod).standard_normal(EX_N).astype(
            np.float32)
        g[np.random.default_rng(10 + pod).random(EX_N) < 0.1] = 0.0
        seed = (17 + 0 * 1_000_003 + pod * 7919 + EX_STEP) & 0xFFFFFFFF
        grads.append(g)
        slabs.append(RC._sample_leaf(jnp.asarray(g), EX_K,
                                     jnp.uint32(seed), 0.01))
    est = []
    for s in slabs:
        e = np.zeros(EX_N, np.float32)
        v = np.asarray(s.valid)
        np.add.at(e, np.maximum(np.asarray(s.keys), 0),
                  np.where(v, np.asarray(s.weights)
                           / np.maximum(np.asarray(s.probs), 1e-30), 0.0)
                  .astype(np.float32))
        est.append(e)
    total = (np.zeros(EX_N, np.float32) + est[0]) + est[1]
    return [((total - est[p]) + grads[p]) / np.float32(2) for p in (0, 1)]


def test_two_pod_exchange_matches_the_reference_formula(ranks):
    want = _reference_exchange(None)
    for r in ranks:
        got = r["exchange"]
        np.testing.assert_allclose(got["big"].reshape(-1), want[r["pod"]],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(got["small"], np.full(100, 1.5,
                                                            np.float32))
    # the pods keep their own exact share, so they differ by design
    assert not np.array_equal(ranks[0]["exchange"]["big"],
                              ranks[2]["exchange"]["big"])
    np.testing.assert_array_equal(ranks[0]["exchange"]["big"],
                                  ranks[1]["exchange"]["big"])


def test_multipod_dense_training_converges(ranks):
    l = ranks[0]["dense"]
    assert all(r["dense"] == l for r in ranks)
    assert l[-1] < l[0] * 0.6


def test_sampled_gradient_exchange_converges(ranks):
    l = ranks[0]["compressed"]
    assert all(r["compressed"] == l for r in ranks)
    assert l[-1] < l[0] * 0.8  # unbiased but noisier than dense


def test_train_main_runs_on_the_mesh_and_rank0_checkpoints(ranks):
    assert all(r["main_step"] == 2 for r in ranks)
    assert sorted(os.listdir(ranks[0]["dir"] / "ck")) == ["step_0000000002"]


def test_microbatch_matches_dense_loss(ranks):
    assert abs(ranks[0]["microbatch"][0] - ranks[0]["dense"][0]) < 5e-2
