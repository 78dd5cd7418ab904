"""Parity of the port's training path with the JAX package, on the CPU:
the data pipeline, the sampled gradient exchange's leaf sampler and merge,
the partition rules, three dense train steps against a single-device JAX
loop, and ``train.main`` with checkpoint, resume and preemption (mirrors
tests/test_system.py and the single-device parts of
tests/test_distribution.py, whose multi-device training cases fail on the
reference under JAX 0.9.0).

Tolerances (tests/torch_parity.py for the slab fields):
  * corpus, tokens and batches bit-identical; the importance pool's keys
    exact, its probabilities within PROB_ULP;
  * ``_sample_leaf``: keys, valid, member, weights exact, probs within
    PROB_ULP, seeds and taus within SEED_ULP; the kernel and plain paths
    bit-identical; ``_merge_leaf`` rtol 1e-6 (sums in another order);
  * three train steps against the JAX loop, activations in float32:
    losses rtol 1e-5 (measured 2.4e-7), params rtol 1e-4 / atol 1e-6
    after three AdamW updates, the finalized telemetry slab's keys and
    member exact, weights rtol 1e-5;
  * resume on the CPU: bit-identical losses and restored state.
"""
import dataclasses
import os
import shutil
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as C
from repro.data import pipeline as RP
from repro.distopt import compression as RC
from repro.launch import sharding as RSh
from repro.launch import steps as RSt
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.configs import registry as RR

import repro_torch.core as T
from repro_torch import interop, tree as TT
from repro_torch.configs import registry as TR
from repro_torch.data import pipeline as TP
from repro_torch.distopt import compression as TC
from repro_torch.launch import mesh as TMe
from repro_torch.launch import sharding as TSh
from repro_torch.launch import steps as TSt
from repro_torch.launch import train as TTr
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from tests.torch_parity import PROB_ULP, SEED_ULP, assert_ulp, to_np

CPU = "cpu"


@pytest.fixture
def f32_acts():
    old_r, old_t = RM.ACT_DTYPE, TM.ACT_DTYPE
    RM.ACT_DTYPE, TM.ACT_DTYPE = jnp.float32, torch.float32
    yield
    RM.ACT_DTYPE, TM.ACT_DTYPE = old_r, old_t


# ---------------------------------------------------------- data pipeline
DCFG = dict(vocab_size=128, seq_len=16, global_batch=4, n_docs=2000, seed=3)


def test_corpus_tokens_and_batches_are_bit_identical():
    rc, tc = RP.DataConfig(**DCFG), TP.DataConfig(**DCFG)
    rcorp, tcorp = RP.SyntheticCorpus(rc), TP.SyntheticCorpus(tc)
    np.testing.assert_array_equal(rcorp.domain, tcorp.domain)
    np.testing.assert_array_equal(rcorp.weights, tcorp.weights)
    assert tcorp.weights.dtype == np.float32
    docs = np.array([0, 5, 1999, 5])
    np.testing.assert_array_equal(rcorp.tokens(docs, 40),
                                  tcorp.tokens(docs, 40))
    rl, tl = RP.Loader(rcorp, rc), TP.Loader(tcorp, tc)
    for step in (0, 1, 7, 123):
        rb, tb = rl.batch(step), tl.batch(step)
        for k in ("tokens", "docs"):
            np.testing.assert_array_equal(rb[k], tb[k])
    for f, seg in ((C.SUM, None), (C.COUNT, 3)):
        tf = {"sum": T.SUM, "count": T.COUNT}[f.name]
        assert tl.corpus_stats(tf, seg) == pytest.approx(
            rl.corpus_stats(f, seg), rel=1e-5)


def test_importance_pool_matches_the_reference():
    rc, tc = RP.DataConfig(**DCFG), TP.DataConfig(**DCFG)
    rl = RP.Loader(RP.SyntheticCorpus(rc), rc, importance=True, k=64)
    tl = TP.Loader(TP.SyntheticCorpus(tc), tc, importance=True, k=64,
                   device=CPU)
    np.testing.assert_array_equal(rl.pool, tl.pool)
    assert_ulp(rl.pool_p, tl.pool_p, PROB_ULP, "pool_p")
    for seg in (None, 2):
        assert tl.sketch_stats(T.SUM, seg) == pytest.approx(
            rl.sketch_stats(C.SUM, seg), rel=1e-5)
    with pytest.raises(ValueError, match="importance"):
        TP.Loader(TP.SyntheticCorpus(tc), tc).sketch_stats(T.SUM)


def test_data_loader_deterministic_and_importance_unbiased():
    """tests/test_system.py::test_data_loader_deterministic_and_
    importance_unbiased on the port."""
    dcfg = TP.DataConfig(**DCFG)
    corpus = TP.SyntheticCorpus(dcfg)
    l1, l2 = TP.Loader(corpus, dcfg), TP.Loader(corpus, dcfg)
    b1, b2 = l1.batch(7), l2.batch(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(l1.batch(8)["tokens"], b1["tokens"])
    li = TP.Loader(corpus, dcfg, importance=True, k=64, device=CPU)
    assert len(li.pool) > 0
    keys = np.arange(dcfg.n_docs, dtype=np.int32)
    act = np.ones(dcfg.n_docs, bool)
    s = T.universal_monotone_sample(keys, corpus.weights, act, 64, seed=3,
                                    device=CPU)
    for f in (T.SUM, T.COUNT, T.thresh(1.0)):
        est = float(T.estimate(f, corpus.weights, s.prob, s.member,
                               device=CPU))
        ex = float(T.exact(f, corpus.weights, act, device=CPU))
        assert abs(est / ex - 1) < 4 / np.sqrt(63), f.name


# ------------------------------------------------ the exchange's sampler
def _grad(n, seed, zeros=0.1, ties=0.3):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    t = rng.random(n) < ties
    g[t] = np.round(g[t], 1)
    g[rng.random(n) < zeros] = 0.0
    return g


@pytest.mark.parametrize("n,k,seed", [(20_000, 256, 17), (5_000, 64, 12345),
                                      (300, 256, 4_000_000_123),
                                      (50, 8, 99)])
def test_sample_leaf_matches_the_reference(n, k, seed):
    g = _grad(n, seed % 1000)
    ref = RC._sample_leaf(jnp.asarray(g), k, jnp.uint32(seed), 0.01)
    got = TC._sample_leaf(torch.from_numpy(g), k, seed, 0.01)
    plain = TC._sample_leaf(torch.from_numpy(g), k, seed, 0.01,
                            use_kernels=False)
    for name in ("keys", "valid", "member", "aux", "weights"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      to_np(getattr(got, name)), err_msg=name)
    assert_ulp(ref.probs, got.probs, PROB_ULP, "probs")
    assert_ulp(ref.seeds, got.seeds, SEED_ULP, "seeds")
    assert_ulp(ref.taus, got.taus, SEED_ULP, "taus")
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    nv = int(got.valid.sum())
    assert 0 < nv <= 3 * min(k, n)
    assert bool((got.keys[:nv] >= 0).all()) and bool(
        (got.keys[nv:] == -1).all())


def test_sample_leaf_of_a_zero_gradient_is_empty():
    got = TC._sample_leaf(torch.zeros(1000), 16, 3, 0.01)
    ref = RC._sample_leaf(jnp.zeros(1000), 16, jnp.uint32(3), 0.01)
    assert not bool(got.valid.any())
    np.testing.assert_array_equal(np.asarray(ref.keys), to_np(got.keys))
    np.testing.assert_array_equal(np.asarray(ref.probs), to_np(got.probs))


def test_merge_leaf_matches_the_reference():
    n = 4000
    slabs = [RC._sample_leaf(jnp.asarray(_grad(n, s)), 64, jnp.uint32(s),
                             0.01) for s in (1, 2)]
    idx, val, prob, valid = (np.stack([np.asarray(getattr(s, f))
                                       for s in slabs])
                             for f in ("keys", "weights", "probs", "valid"))
    ref = np.asarray(RC._merge_leaf(*(jnp.asarray(x) for x in
                                      (idx, val, prob, valid)), n, 2))
    got = TC._merge_leaf(*(torch.from_numpy(x) for x in
                           (idx, val, prob, valid)), n, 2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert np.count_nonzero(got) > 0


def test_exchange_at_one_pod_returns_the_input_gradient():
    mesh = TMe.Mesh((1, 1, 1), ("pod", "data", "model"), device=CPU)
    rng = np.random.default_rng(0)
    grads = {"big": torch.from_numpy(_grad(70_000, 1).reshape(70, 1000)),
             "small": {"b": torch.from_numpy(
                 rng.standard_normal(100).astype(np.float32))}}
    keep = dict(TT.flatten(grads))
    out, wires = TC.exchange_grads(mesh, grads, 3, k=256, return_wires=True)
    assert grads == {} and set(wires) == {"big"}
    assert wires["big"].shape == (1, 4, 768)
    for path, g in TT.flatten(out):
        assert torch.equal(g, keep[path]), path


# ---------------------------------------------------- partition rules
class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", RR.list_archs())
def test_partition_specs_match_the_reference(arch):
    shapes, specs = RSt.abstract_params(RR.get_config(arch))
    is_spec = lambda s: isinstance(s, tuple)
    flat_specs = dict(TT.flatten(jax.tree.map(lambda s: s, specs,
                                              is_leaf=is_spec)))
    flat_shapes = dict(TT.flatten(shapes))
    for mesh in (_FakeMesh({"data": 16, "model": 16}),
                 _FakeMesh({"pod": 2, "data": 4, "model": 8}),
                 _FakeMesh({"data": 8, "model": 1})):
        for fsdp in (False, True):
            for path, spec in flat_specs.items():
                shape = tuple(flat_shapes[path].shape)
                want = tuple(RSh.logical_to_pspec(spec, shape, mesh, fsdp))
                assert TSh.logical_to_pspec(spec, shape, mesh, fsdp) == \
                    want, (path, mesh.shape, fsdp)
        assert TSh.batch_pspec(mesh) == tuple(RSh.batch_pspec(mesh))


def test_partition_rules_divisibility():
    """tests/test_distribution.py::test_partition_rules_divisibility."""
    mesh = _FakeMesh({"data": 16, "model": 16})
    assert TSh.logical_to_pspec(("embed", "q_heads"), (1536, 1536),
                                mesh) == (None, "model")
    assert TSh.logical_to_pspec(("vocab", "embed"), (49155, 1024),
                                mesh) == ()
    assert TSh.logical_to_pspec(("expert", "embed", "mlp"),
                                (32, 1024, 512), mesh) == ("model",)


def test_mesh_layout_and_batch_slices():
    mesh = TMe.Mesh((1, 1, 1), ("pod", "data", "model"), device=CPU)
    assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    assert TMe.batch_axes(mesh) == ("pod", "data")
    assert TSh.batch_slice(mesh, 8) == slice(0, 8)
    fake = _FakeMesh({"pod": 2, "data": 2, "model": 1})
    fake.coords = {"pod": 1, "data": 0, "model": 0}
    assert TSh.batch_slice(fake, 8) == slice(4, 6)
    with pytest.raises(ValueError, match="split"):
        TSh.batch_slice(fake, 6)
    # a model axis > 1 is placed now; at world size 1 it lacks processes
    with pytest.raises(ValueError, match="processes"):
        TMe.Mesh((1, 2), ("data", "model"), device=CPU)
    with pytest.raises(ValueError, match="processes"):
        TMe.Mesh((2, 1), ("data", "model"), device=CPU)
    with pytest.raises(ValueError, match="processes"):
        TMe.make_production_mesh(device=CPU)
    assert TMe.make_host_mesh(device=CPU).shape == {"data": 1, "model": 1}
    st = TSt.state_specs(TR.get_smoke_config("qwen2-1.5b"), mesh,
                         telemetry=TTr.TEL_SPEC)
    assert st["opt"]["m"]["layers"]["attn"]["wq"] == (None, None, "model")
    assert st["tel"].keys == () and st["opt"]["step"] == ()
    ins = TSt.input_specs(TR.get_smoke_config("qwen2-1.5b"),
                          TSt.ShapeConfig("t", 32, 4, "train"))
    assert ins["tokens"].shape == (4, 32)


# ------------------------------------------------ three dense train steps
def test_three_steps_match_a_single_device_jax_loop(f32_acts):
    """Telemetry and the sampled exchange at one pod (which returns its
    input) against loss_fn, jax.grad, apply_updates and
    multisketch_absorb_inline on one device, then finalize."""
    arch = "qwen2-1.5b"
    rcfg = RR.get_smoke_config(arch)
    cfg = TR.get_smoke_config(arch)
    rparams, _ = RM.init_model(jax.random.PRNGKey(0), rcfg)
    params_np = jax.tree.map(np.asarray, rparams)
    ropt = RA.OptConfig(total_steps=60, warmup_steps=3, peak_lr=5e-3)
    tel = C.MultiSketchSpec(objectives=((C.SUM, 64), (C.COUNT, 64),
                                        (C.thresh(5.0), 64)), seed=1234)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
               for _ in range(3)]

    rstate = {"params": rparams, "opt": RA.init_opt_state(rparams),
              "tel": C.multisketch_empty(tel)}
    rlosses = []
    for i, toks in enumerate(batches):
        (loss, _), grads = jax.value_and_grad(
            lambda p: RM.loss_fn(p, rcfg, {"tokens": jnp.asarray(toks)}),
            has_aux=True)(rstate["params"])
        new_p, new_opt, _ = RA.apply_updates(rstate["params"], grads,
                                             rstate["opt"], ropt)
        tkeys = i * (1 << 16) + jnp.arange(4, dtype=jnp.int32)
        rstate = {"params": new_p, "opt": new_opt,
                  "tel": C.multisketch_absorb_inline(
                      tel, rstate["tel"], tkeys, jnp.full((4,), loss))}
        rlosses.append(float(loss))
    rtel = C.multisketch_finalize(rstate["tel"], spec=tel)

    mesh = TMe.Mesh((1, 1, 1), ("pod", "data", "model"), device=CPU)
    step, _ = TSt.make_train_step(cfg, TA.OptConfig(**ropt.__dict__), mesh,
                                  compress=dict(k=256, min_size=1024),
                                  telemetry=TTr.TEL_SPEC)
    tparams = interop.model_params_from_arrays(cfg, params_np, device=CPU)
    state = {"params": tparams, "opt": TA.init_opt_state(tparams),
             "tel": T.multisketch_empty(TTr.TEL_SPEC, device=CPU)}
    tlosses = []
    for toks in batches:
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        tlosses.append(float(m["loss"]))
    np.testing.assert_allclose(tlosses, rlosses, rtol=1e-5)
    assert int(state["opt"]["step"]) == 3
    for (p, a), (_, b) in zip(TT.flatten(jax.tree.map(
            np.asarray, rstate["params"])), TT.flatten(state["params"])):
        if p == "layers.attn.bk":
            # a key bias shifts all of a query's scores alike, which the
            # softmax cancels: its gradient is rounding noise on both
            # sides, and Adam scales that noise up to full steps
            continue
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-6,
                                   err_msg=p)
    ttel = T.multisketch_finalize(state["tel"], spec=TTr.TEL_SPEC)
    for name in ("keys", "member", "valid", "aux"):
        np.testing.assert_array_equal(np.asarray(getattr(rtel, name)),
                                      to_np(getattr(ttel, name)))
    np.testing.assert_allclose(to_np(ttel.weights), np.asarray(rtel.weights),
                               rtol=1e-5)


def test_microbatch_matches_the_full_batch_loss(f32_acts):
    cfg = TR.get_smoke_config("qwen2-1.5b")
    mesh = TMe.Mesh((1, 1), ("data", "model"), device=CPU)
    params, _ = TM.init_model(cfg, seed=0, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32))
    opt = TA.OptConfig(total_steps=60, warmup_steps=3, peak_lr=5e-3)
    out = []
    for mb in (None, 2, 4):
        step, _ = TSt.make_train_step(cfg, opt, mesh, microbatch=mb)
        _, m = step({"params": params, "opt": TA.init_opt_state(params)},
                    {"tokens": toks})
        out.append(float(m["loss"]))
    assert abs(out[0] - out[1]) < 5e-2 and abs(out[0] - out[2]) < 5e-2
    seen = []
    step, _ = TSt.make_train_step(
        cfg, opt, mesh,
        grad_transform=lambda g, p, s: seen.append(int(s)) or g)
    step({"params": params, "opt": TA.init_opt_state(params)},
         {"tokens": toks})
    assert seen == [0]
    # FSDP at data 1 places every leaf whole: the same step
    step, specs = TSt.make_train_step(dataclasses.replace(cfg, fsdp=True),
                                      opt, mesh)
    assert specs["params"]["layers"]["mlp"]["wi"] == (None, "data", "model")
    _, m = step({"params": params, "opt": TA.init_opt_state(params)},
                {"tokens": toks})
    assert float(m["loss"]) == out[0]


# ---------------------------------------------------- train.main, resume
_ARGS = ["--device", "cpu", "--smoke", "--steps", "4", "--batch", "4",
         "--seq", "32", "--mesh", "1x1x1", "--compress",
         "--importance-sampling", "--ckpt-every", "2", "--log-every", "1"]


def _run(argv):
    losses, restored = {}, {}

    def cb(event, **kw):
        if event == "step":
            losses[kw["step"]] = float(kw["metrics"]["loss"])
            if kw["step"] == 2:
                restored["saved"] = {p: x.clone() for p, x in _leaves(
                    kw["state"])}
        elif event == "restored":
            restored["state"] = dict(_leaves(kw["state"]))
            restored["step"] = kw["step"]
    state = TTr.main(argv, callback=cb)
    return state, losses, restored


def _leaves(state):
    out = TT.flatten({"params": state["params"], "opt": state["opt"]})
    out += [(f"tel.{n}", x) for n, x in zip(state["tel"]._fields,
                                            state["tel"])]
    return out


def test_train_main_checkpoints_and_resumes(tmp_path):
    d = str(tmp_path / "ck")
    state, losses, first = _run(_ARGS + ["--ckpt-dir", d])
    assert sorted(losses) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for v in losses.values())
    assert os.listdir(d) and int(state["opt"]["step"]) == 4
    shutil.rmtree(os.path.join(d, "step_0000000004"))
    _, again, res = _run(_ARGS + ["--ckpt-dir", d, "--resume"])
    assert res["step"] == 2 and sorted(again) == [3, 4]
    for p, x in first["saved"].items():
        assert torch.equal(res["state"][p], x), p
    assert again == {s: losses[s] for s in (3, 4)}


def test_resume_without_telemetry_arrays_starts_it_fresh(tmp_path):
    from repro_torch.ckpt.manager import CheckpointManager
    d = str(tmp_path / "ck")
    state, _, _ = _run(_ARGS[:4] + ["1"] + _ARGS[5:] + ["--ckpt-dir", d])
    CheckpointManager(d).save(7, {"params": state["params"],
                                  "opt": state["opt"]})
    shutil.rmtree(os.path.join(d, "step_0000000001"))
    _, losses, res = _run(_ARGS[:4] + ["8"] + _ARGS[5:]
                          + ["--ckpt-dir", d, "--resume"])
    assert res["step"] == 7 and sorted(losses) == [8]
    assert not bool(res["state"]["tel.valid"].any())


def test_sigterm_checkpoints_and_exits_cleanly(tmp_path):
    d = str(tmp_path / "ck")
    old = signal.getsignal(signal.SIGTERM)

    def cb(event, **kw):
        if event == "step" and kw["step"] == 1:
            os.kill(os.getpid(), signal.SIGTERM)
    try:
        with pytest.raises(SystemExit) as ex:
            TTr.main(_ARGS + ["--ckpt-dir", d, "--ckpt-every", "50"],
                     callback=cb)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert ex.value.code == 0
    assert sorted(os.listdir(d)) == ["step_0000000001"]


def test_train_main_rejects_unported_families():
    """The encoder and vlm families train through ``train.main`` (their
    smoke configs, 2 steps with the exchange); internvl2-76b's full config
    places (FSDP) rather than raising."""
    for arch in ("hubert-xlarge", "internvl2-76b"):
        losses = []
        state = TTr.main(["--device", "cpu", "--smoke", "--arch", arch,
                          "--steps", "2", "--batch", "2", "--seq", "32",
                          "--mesh", "1x1x1", "--compress"],
                         callback=lambda ev, **kw: ev == "step" and
                         losses.append(float(kw["metrics"]["loss"])))
        assert len(losses) == 2 and np.all(np.isfinite(losses)), arch
        assert int(state["opt"]["step"]) == 2
    mesh = TMe.Mesh((1, 1), ("data", "model"), device=CPU)
    _, specs = TSt.make_train_step(TR.get_config("internvl2-76b"),
                                   TA.OptConfig(), mesh)
    assert specs["params"]["layers"]["mlp"]["wi"] == (None, "data", "model")


def test_train_main_starts_its_own_process_group(tmp_path):
    """``--dist-url/--world-size/--rank`` start the default group (here a
    one-rank gloo group on a free localhost port) before the mesh."""
    import socket
    import subprocess
    import sys
    from pathlib import Path
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    code = ("import torch.distributed as dist\n"
            "from repro_torch.launch import train\n"
            f"train.main({_ARGS[:4] + ['1'] + _ARGS[5:]!r} + ["
            f"'--dist-url', 'tcp://localhost:{port}', '--world-size', '1',"
            f" '--rank', '0'])\n"
            "print('backend', dist.get_backend())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "step     1 loss" in out.stdout and "backend gloo" in out.stdout
