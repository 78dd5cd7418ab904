"""Parity of the port's state-space families with the JAX package, on the
CPU: ``models/mamba.py`` (Mamba-1 S6, Mamba-2 SSD) and the ssm / hybrid
branches of ``models/model.py``, on the smoke configs falcon-mamba-smoke
(Mamba-1) and zamba2-smoke (Mamba-2 with the shared attention block).

The same parameters (the reference's ``init_model``, carried over by
``interop.model_params_from_arrays``) and the same numpy inputs go through
both packages, activations in float32 on both sides. The tests that
mirror the reference's all-family tests hold these families beside the
others: ``tests/test_torch_models.py`` (loss and every gradient against
``jax.grad``, forward logits) and ``tests/test_torch_decode.py``
(``make_cache`` / ``grow_cache``, ``prefill`` and each ``serve_step``
against the reference, ``test_smoke_decode_consistency``,
``test_prefill_then_decode``, ``serve.main``). Tolerances, with the
largest gaps measured on the CPU:

  * the init tree, the spec tree and the interop round trip: exact;
  * ``_causal_conv`` and ``_conv_step``: 1e-6 x scale (measured 7.9e-8:
    the K-tap sums run in another order);
  * ``apply_mamba1`` / ``apply_mamba2`` outputs, final states and a decode
    step from them: 1e-5 x scale (measured 4.4e-7; the doubling scan
    associates in another order than ``lax.associative_scan``);
  * chunked against sequential decode: the reference's own bar, 1e-4
    absolute (measured 4.4e-10 for Mamba-1, 3.0e-7 for Mamba-2);
  * three train steps of zamba2-smoke with the exchange against a JAX
    loop: losses rtol 1e-5, params rtol 1e-4 / atol 1e-4 (the MoE test's
    bars);
  * shapes, specs, partition specs, launch counts: exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as RR
from repro.launch import sharding as RSh
from repro.models import mamba as RMa
from repro.models import model as RM
from repro.optim import adamw as RA

from repro_torch import interop, tree as TT
from repro_torch.configs import registry as TR
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.distopt import compression as TC
from repro_torch.kernels import blockselect as KB
from repro_torch.kernels import compact as KC
from repro_torch.kernels import seeds as KS
from repro_torch.launch import mesh as TMe
from repro_torch.launch import sharding as TSh
from repro_torch.launch import steps as TSt
from repro_torch.launch import train as TTr
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMa
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as TA

CPU = "cpu"
SSM = ["falcon-mamba-7b", "zamba2-2.7b"]
REL = 1e-5


@pytest.fixture
def f32_acts():
    old_r, old_t = RM.ACT_DTYPE, TM.ACT_DTYPE
    RM.ACT_DTYPE, TM.ACT_DTYPE = jnp.float32, torch.float32
    yield
    RM.ACT_DTYPE, TM.ACT_DTYPE = old_r, old_t


def _setup(arch, seed=0, **replace):
    rcfg = dataclasses.replace(RR.get_smoke_config(arch), **replace)
    cfg = dataclasses.replace(TR.get_smoke_config(arch), **replace)
    params, specs = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    pn = jax.tree.map(np.asarray, params)
    return rcfg, cfg, pn, specs, interop.model_params_from_arrays(
        cfg, pn, device=CPU)


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    gap = float(np.abs(got - want).max())
    assert gap <= rel * max(scale, 1e-12), (what, gap, scale)


# ---------------------------------------------------- init and interop
@pytest.mark.parametrize("arch", SSM)
def test_init_tree_specs_and_interop_match_the_reference(arch):
    rcfg, cfg, pn, rspecs, tree = _setup(arch)
    tparams, tspecs = TM.init_model(cfg, seed=0, device=CPU)
    rflat, tflat = TT.flatten(pn), TT.flatten(tparams)
    assert [p for p, _ in rflat] == [p for p, _ in tflat]
    for (path, r), (_, t) in zip(rflat, tflat):
        assert r.shape == tuple(t.shape) and t.dtype == torch.float32, path
    rs = dict(TT.flatten(jax.tree.map(
        lambda s: s, rspecs, is_leaf=lambda s: isinstance(s, tuple))))
    assert rs == dict(TT.flatten(tspecs))
    meta, mspecs = TM.abstract_params(cfg)
    assert mspecs == tspecs and all(
        m.is_meta and m.shape == t.shape
        for (_, m), (_, t) in zip(TT.flatten(meta), tflat))
    # the hybrid's shared block is one unstacked subtree
    if cfg.family == "hybrid":
        assert tparams["shared"]["attn"]["wq"].shape == (cfg.d_model,
                                                         cfg.q_dim)
        assert tspecs["shared"]["attn"]["wq"] == ("embed", "q_heads")
    # the draws: conv weights 0.1 x N(0, 1) (untruncated), softplus of
    # dt_bias in [1e-3, 1e-1), Mamba-1's A_log = log(1..N), Mamba-2's in
    # [0, log 16)
    mp = tparams["layers"]["mamba"]
    conv = mp["conv_w"] if "conv_w" in mp else mp["conv_x"]
    assert 0.05 < float(conv.std()) < 0.15
    dt = torch.nn.functional.softplus(mp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) < 1e-1 * (1 + 1e-5)
    if cfg.ssm_kind == "mamba1":
        want = torch.log(torch.arange(1, cfg.ssm_state + 1,
                                      dtype=torch.float32))
        assert torch.equal(mp["A_log"], want.expand_as(mp["A_log"]))
    else:
        assert 0.0 <= float(mp["A_log"].min())
        assert float(mp["A_log"].max()) < np.log(16.0)
    # the interop round trip, exact
    back = interop.model_params_to_arrays(TM.Model(cfg, tree).tree())
    for (p, a), (q, b) in zip(rflat, TT.flatten(back)):
        assert p == q and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ the conv helpers
@pytest.mark.parametrize("C,K", [(16, 4), (7, 2)])
def test_causal_conv_and_conv_step_match_the_reference(C, K):
    rng = np.random.default_rng(C)
    x = rng.standard_normal((2, 9, C)).astype(np.float32)
    w = (0.3 * rng.standard_normal((C, K))).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    want = RMa._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = TMa._causal_conv(*map(torch.from_numpy, (x, w, b)))
    _close(got, want, 1e-6, "causal conv")
    st = rng.standard_normal((2, K - 1, C)).astype(np.float32)
    rs, ry = RMa._conv_step(jnp.asarray(st), jnp.asarray(x[:, 0]),
                            jnp.asarray(w), jnp.asarray(b))
    ts, ty = TMa._conv_step(torch.from_numpy(st), torch.from_numpy(x[:, 0]),
                            torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    _close(ty, ry, 1e-6, "conv step")
    # the step over a zero state is the conv's first position
    zs = torch.zeros((2, K - 1, C))
    _close(TMa._conv_step(zs, torch.from_numpy(x[:, 0]), torch.from_numpy(w),
                          torch.from_numpy(b))[1], got[:, 0].numpy(), 1e-6)


# ------------------------------------------------------ the SSM blocks
@pytest.mark.parametrize("arch", SSM)
@pytest.mark.parametrize("S,chunk", [(32, 8), (20, 8)])
def test_apply_block_matches_the_reference(arch, S, chunk):
    """Full sequence with return_state (S = 32 at chunk 8: 4 chunks;
    S = 20: 2 chunks of 10 != ssm_chunk), then one decode step from the
    returned state."""
    rcfg, cfg, pn, _, tree = _setup(arch, ssm_chunk=chunk)
    kind = cfg.ssm_kind
    rap = getattr(RMa, f"apply_{kind}")
    tap = getattr(TMa, f"apply_{kind}")
    rp = jax.tree.map(lambda t: jnp.asarray(t[0]), pn["layers"]["mamba"])
    tp = {n: t[0] for n, t in tree["layers"]["mamba"].items()}
    rng = np.random.default_rng(S)
    x = (0.5 * rng.standard_normal((2, S, cfg.d_model))).astype(np.float32)
    ry, rst = rap(rp, jnp.asarray(x), rcfg, return_state=True)
    with torch.no_grad():
        ty, tst = tap(tp, torch.from_numpy(x), cfg, return_state=True)
    _close(ty, ry, what="y")
    assert set(tst) == set(rst)
    for name in rst:
        assert tst[name].dtype == torch.float32
        _close(tst[name], rst[name], what=name)
    xn = (0.5 * rng.standard_normal((2, 1, cfg.d_model))).astype(np.float32)
    ry1, rst1 = rap(rp, jnp.asarray(xn), rcfg, state=rst)
    with torch.no_grad():
        ty1, tst1 = tap(tp, torch.from_numpy(xn), cfg, state=tst)
    _close(ty1, ry1, what="step y")
    for name in rst1:
        _close(tst1[name], rst1[name], what=f"step {name}")


def _tiny(kind):
    """The reference's test_mamba_chunked_equals_sequential config (and
    its Mamba-2 twin)."""
    return ModelConfig(name="t", family="ssm", num_layers=1, d_model=32,
                       vocab_size=64, ssm_kind=kind, ssm_state=4,
                       ssm_chunk=8, ssm_head_dim=8)


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_mamba_chunked_equals_sequential(kind):
    """The reference's test (Mamba-1) and the same for Mamba-2, which the
    reference lacks: the chunked scan over 32 tokens (4 chunks) equals 32
    single-token decode steps, within the reference's 1e-4."""
    cfg = _tiny(kind)
    init = getattr(TMa, f"init_{kind}")
    apply = getattr(TMa, f"apply_{kind}")
    p, _ = init(TL.Init(CPU, 0), cfg)
    x = 0.1 * torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32)).astype(np.float32))
    with torch.no_grad():
        y_full, _ = apply(p, x, cfg)
        st = getattr(TMa, f"{kind}_state")(cfg, 2)
        ys = []
        for t in range(32):
            yt, st = apply(p, x[:, t:t + 1], cfg, state=st)
            ys.append(yt)
    assert float((y_full - torch.cat(ys, 1)).abs().max()) < 1e-4


def test_chunk_rule_and_short_prompt_raise(f32_acts):
    """The port takes exactly the lengths the reference takes (nC =
    max(S // ssm_chunk, 1), Ck = S // nC, nC * Ck == S) and raises
    ValueError naming the rule for the others; a prefill shorter than
    ssm_conv - 1 tokens raises ValueError (the reference returns a short
    conv state that its first decode step cannot take)."""
    for S in range(1, 70):
        nC = max(S // 8, 1)
        ok = nC * (S // nC) == S
        if ok:
            assert TMa._chunk_plan(S, 8) == (nC, S // nC)
        else:
            with pytest.raises(ValueError, match=r"nC \* Ck == S"):
                TMa._chunk_plan(S, 8)
    cfg = dataclasses.replace(TR.get_smoke_config("falcon-mamba-7b"),
                              ssm_chunk=256)
    p = {n: t[0] for n, t in TM.init_model(
        cfg, device=CPU)[0]["layers"]["mamba"].items()}
    with torch.no_grad():
        for S, good in ((601, False), (600, True)):
            x = torch.zeros((1, S, cfg.d_model))
            if good:
                assert TMa.apply_mamba1(p, x, cfg)[0].shape == x.shape
            else:
                with pytest.raises(ValueError, match="601 does not split"):
                    TMa.apply_mamba1(p, x, cfg)
    for arch in SSM:
        cfg = TR.get_smoke_config(arch)
        tree, _ = TM.init_model(cfg, device=CPU)
        K = cfg.ssm_conv
        short = torch.zeros((2, K - 2), dtype=torch.int32)
        with pytest.raises(ValueError, match="conv state shorter"):
            TM.prefill(tree, cfg, {"tokens": short})
        _, cache = TM.prefill(tree, cfg, {"tokens": torch.zeros(
            (2, K - 1), dtype=torch.int32)})
        conv = cache["conv"] if "conv" in cache else cache["mamba"]["conv_x"]
        assert conv.shape[2] == K - 1


def test_hybrid_decay_is_masked_before_the_exp(f32_acts):
    """Mamba-2's intra-chunk decay exp(cum_t - cum_s) above the diagonal
    overflows fp32 when dt |A| sums past ~88 inside a chunk. The
    reference masks after the exp, so inf meets a zero cotangent and its
    gradient is NaN; the port masks before it: the same forward values,
    finite gradients."""
    rcfg, cfg, pn, _, tree = _setup("zamba2-2.7b")
    rp = jax.tree.map(lambda t: jnp.asarray(t[0]), pn["layers"]["mamba"])
    tp = {n: t[0].clone() for n, t in tree["layers"]["mamba"].items()}
    big = np.full(cfg.ssm_heads, 12.0, np.float32)     # dt ~ 12, |A| ~ 16
    rp = {**rp, "dt_bias": jnp.asarray(big),
          "A_log": jnp.full((cfg.ssm_heads,), np.log(15.0), jnp.float32)}
    tp["dt_bias"] = torch.from_numpy(big)
    tp["A_log"] = torch.full((cfg.ssm_heads,), float(np.log(15.0)))
    x = (0.5 * np.random.default_rng(1).standard_normal(
        (1, 8, cfg.d_model))).astype(np.float32)
    ry, _ = RMa.apply_mamba2(rp, jnp.asarray(x), rcfg)
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, _ = TMa.apply_mamba2(tp, xt, cfg)
    _close(ty, ry, what="y")
    rg = jax.grad(lambda x: jnp.sum(RMa.apply_mamba2(rp, x, rcfg)[0]))(
        jnp.asarray(x))
    assert not bool(jnp.isfinite(rg).all())        # the reference's NaN
    (tg,) = torch.autograd.grad(ty.sum(), xt)
    assert bool(torch.isfinite(tg).all())


@pytest.mark.parametrize("arch", SSM)
def test_remat_gives_the_same_gradients_bit_for_bit(arch, f32_acts):
    """Layer (ssm) or group (hybrid) recomputation in backward, on top of
    the per-chunk one, changes no bit of the loss or the gradients."""
    cfg = TR.get_smoke_config(arch)
    tree, _ = TM.init_model(cfg, seed=2, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    out = []
    for remat in (True, False):
        model = TM.Model(dataclasses.replace(cfg, remat=remat),
                         TT.tree_map(torch.clone, tree))
        loss, _ = model({"tokens": toks})
        named = list(model.named_parameters())
        out.append((loss.detach(), torch.autograd.grad(
            loss, [p for _, p in named])))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ------------------------------------------- caches, specs and partitions
@pytest.mark.parametrize("arch", SSM)
def test_cache_pspecs_follow_the_reference_rule(arch):
    """The nested {"mamba": {...}, "k", "v"} / {"conv", "h"} caches:
    batch on dim 1, the largest divisible remaining dim on "model", as
    the reference's cache_shardings."""
    cfg, rcfg = TR.get_smoke_config(arch), RR.get_smoke_config(arch)
    shape = ShapeConfig("d", 64, 4, "decode")
    rmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    want = RSh.cache_shardings(jax.eval_shape(
        lambda: RM.make_cache(rcfg, 4, 64)), rcfg, rmesh)
    want = dict(TT.flatten(jax.tree.map(lambda s: tuple(s.spec), want)))
    cache = TSt.cache_abstract(cfg, shape)
    mesh = TMe.Mesh((1, 1), ("data", "model"), device=CPU)
    got = dict(TT.flatten(TSh.cache_pspecs(cache, cfg, mesh)))
    assert got == want
    # the step factories and input specs take both families
    _, _, csp = TSt.make_serve_step(cfg, shape, mesh)
    assert dict(TT.flatten(csp)) == want
    assert TSt.make_prefill_step(cfg, mesh, shape)[2] == csp
    assert TSt.input_specs(cfg, shape)["tokens"].shape == (4,)
    assert TSt.input_specs(cfg, ShapeConfig("p", 64, 4, "prefill"))[
        "tokens"].shape == (4, 64)

    class _M:
        def __init__(self, shape):
            self.shape = dict(shape)
            self.axis_names = tuple(shape)
    big = dict(TT.flatten(TSh.cache_pspecs(cache, cfg, _M(
        {"pod": 2, "data": 2, "model": 4}))))
    if cfg.family == "ssm":      # conv [L, B, 3, di], h [L, B, di, N]
        assert big == {"conv": (None, ("pod", "data"), None, "model"),
                       "h": (None, ("pod", "data"), "model")}
    else:
        assert big["mamba.conv_x"] == (None, ("pod", "data"), None, "model")
        # h [L, B, H, hd, N]: the head dim is the largest past the batch
        assert big["mamba.h"] == (None, ("pod", "data"), None, "model")
        assert big["k"] == (None, ("pod", "data"), "model")


@pytest.mark.parametrize("arch", SSM)
def test_partition_rules_decay_and_exchange_leaves(arch):
    """At full width (meta tensors): partition specs equal to the
    reference's rule at model axes 1, 4 and 8; the exchange's sampled
    leaves (>= 65,536 elements); AdamW decays exactly the ndim >= 2
    leaves (conv_w [L, di, K] and Mamba-1's A_log [L, di, N] among them)."""
    cfg = TR.get_config(arch)
    meta, specs = TM.abstract_params(cfg)
    flat, fspecs = dict(TT.flatten(meta)), dict(TT.flatten(specs))

    class _M:
        def __init__(self, shape):
            self.shape = shape
            self.axis_names = tuple(shape)
    for msize in (1, 4, 8):
        psp = TSh.param_pspecs(specs, meta, _M({"data": 2, "model": msize}))
        for path, spec in TT.flatten(psp):
            want = RSh.logical_to_pspec(
                tuple(fspecs[path]), tuple(flat[path].shape),
                _M({"data": 2, "model": msize}))
            assert spec == tuple(want), (path, msize)
    sampled = sorted(p for p, t in flat.items() if t.numel() >= 65536)
    if arch == "zamba2-2.7b":
        # 19 sampled leaves + the telemetry fold: (20, 21, 1) a step
        assert sampled == sorted(
            ["emb.tok", "emb.out", "layers.ln1.scale"]
            + [f"layers.mamba.{n}" for n in (
                "conv_x", "conv_xb", "norm_scale", "out_proj", "wB", "wC",
                "wdt", "wx", "wz")]
            + [f"shared.attn.{n}" for n in ("wq", "wk", "wv", "wo")]
            + [f"shared.mlp.{n}" for n in ("wg", "wi", "wo")])
        n = flat["layers.mamba.wx"].numel()
        assert n == 707_788_800 and 3 * n < 2 ** 31
        assert sum(t.numel() for t in flat.values()) == 2_422_670_240
    else:
        # falcon-mamba's largest leaves are 2^31 rows: past the exchange's
        # int32 keys, which raises (its full config shards with FSDP, so
        # at data > 1 a rank samples a block of half of them)
        assert flat["layers.mamba.wx"].numel() == 2 ** 31
        assert sum(t.numel() for t in flat.values()) == 7_272_665_088
        with pytest.raises(ValueError, match="int32 keys"):
            TC._sample_leaf(torch.zeros(1).expand(2 ** 31), 256, 0, 0.01)
        _, specs = TSt.make_train_step(cfg, TA.OptConfig(), TMe.Mesh(
            (1, 1), ("data", "model"), device=CPU))
        assert "data" in specs["params"]["layers"]["mamba"]["wx"]
    tcfg = TR.get_smoke_config(arch)
    params = TT.tree_map(torch.ones_like,
                         TM.init_model(tcfg, seed=0, device=CPU)[0])
    zero = TT.tree_map(torch.zeros_like, params)
    new, _, _ = TA.apply_updates(params, zero, {
        "m": TT.tree_map(torch.zeros_like, params),
        "v": TT.tree_map(torch.zeros_like, params),
        "step": torch.tensor(4, dtype=torch.int32)},
        TA.OptConfig(warmup_steps=1, total_steps=10, peak_lr=1e-2))
    for (path, a), (_, b) in zip(TT.flatten(params), TT.flatten(new)):
        assert torch.equal(a, b) == (a.ndim < 2), path
    mp = params["layers"]["mamba"]
    assert (mp["conv_w"] if "conv_w" in mp else mp["conv_x"]).ndim == 3


# ------------------------------------------------------------ training
def _counting(monkeypatch):
    """Count the kernel wrappers' calls by counter name, at the module
    attributes their callers look up at call time (on the CPU each call
    runs the plain version)."""
    counts = {"seeds": 0, "blockselect": 0, "compact": 0}
    for mod, attr, name in ((KS, "fused_seeds", "seeds"),
                            (KS, "fused_seeds_fvals", "seeds"),
                            (KB, "batched_bottomk_select", "blockselect"),
                            (KC, "batched_bottomk_select", "blockselect"),
                            (KC, "retention_priority", "compact")):
        fn = getattr(mod, attr)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    return counts


def test_three_hybrid_steps_match_a_jax_loop_and_count_launches(
        f32_acts, monkeypatch):
    """zamba2-smoke: loss_fn, jax.grad and apply_updates on one device
    against make_train_step with the sampled exchange at one pod (every
    leaf of >= 1024 elements sampled, returned as it came) and the
    telemetry fold; each step calls K1 and K2 once per sampled leaf and
    the fold (1, 2, 1), as the full config's (20, 21, 1) counts them."""
    arch = "zamba2-2.7b"
    rcfg, cfg, pn, _, tree = _setup(arch)
    ropt = RA.OptConfig(total_steps=60, warmup_steps=3, peak_lr=5e-3)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
               for _ in range(3)]
    @jax.jit
    def ref_step(params, opt, toks):
        (loss, _), grads = jax.value_and_grad(
            lambda p: RM.loss_fn(p, rcfg, {"tokens": toks}),
            has_aux=True)(params)
        new_p, new_opt, _ = RA.apply_updates(params, grads, opt, ropt)
        return new_p, new_opt, loss

    rparams = jax.tree.map(jnp.asarray, pn)
    rstate = {"params": rparams, "opt": RA.init_opt_state(rparams)}
    rlosses = []
    for toks in batches:
        new_p, new_opt, loss = ref_step(rstate["params"], rstate["opt"],
                                        jnp.asarray(toks))
        rstate = {"params": new_p, "opt": new_opt}
        rlosses.append(float(loss))
    mesh = TMe.Mesh((1, 1, 1), ("pod", "data", "model"), device=CPU)
    step, _ = TSt.make_train_step(cfg, TA.OptConfig(**ropt.__dict__), mesh,
                                  compress=dict(k=256, min_size=1024),
                                  telemetry=TTr.TEL_SPEC)
    from repro_torch.core import multisketch_empty
    state = {"params": tree, "opt": TA.init_opt_state(tree),
             "tel": multisketch_empty(TTr.TEL_SPEC, device=CPU)}
    nleaf = sum(1 for t in TT.leaves(tree) if t.numel() >= 1024)
    assert nleaf >= 10
    counts = _counting(monkeypatch)
    tlosses = []
    for toks in batches:
        before = dict(counts)
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        tlosses.append(float(m["loss"]))
        assert {k: counts[k] - before[k] for k in counts} == {
            "seeds": nleaf + 1, "blockselect": nleaf + 2, "compact": 1}
    np.testing.assert_allclose(tlosses, rlosses, rtol=1e-5)
    for (p, a), (_, b) in zip(TT.flatten(jax.tree.map(
            np.asarray, rstate["params"])), TT.flatten(state["params"])):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-4,
                                   err_msg=p)


def test_train_main_trains_zamba2_with_the_exchange(monkeypatch):
    """train.main --compress on zamba2-smoke: 2 steps, finite losses, the
    plain path's calls per step (1, 2, 1): the telemetry fold alone, every
    smoke leaf being under the exchange's 65,536 elements."""
    counts = _counting(monkeypatch)
    seen, last = {}, {}

    def cb(ev, **kw):
        if ev == "start":
            last.update(counts)
        elif ev == "step":
            seen[kw["step"]] = (float(kw["metrics"]["loss"]), {
                k: counts[k] - last[k] for k in counts})
            last.update(counts)
    state = TTr.main(
        ["--device", "cpu", "--smoke", "--arch", "zamba2-2.7b", "--steps",
         "2", "--batch", "4", "--seq", "16", "--mesh", "1x1x1",
         "--compress", "--importance-sampling", "--log-every", "1"],
        callback=cb)
    assert sorted(seen) == [1, 2]
    for loss, delta in seen.values():
        assert np.isfinite(loss) and loss > 0
        assert delta == {"seeds": 1, "blockselect": 2, "compact": 1}
    assert int(state["opt"]["step"]) == 2
    assert int(state["tel"].valid.sum()) == 8
