"""Parity of the port's model substrate and optimizer with the JAX package.

The same parameters (the reference's init, carried over by
``interop.model_params_from_arrays``) and the same numpy batches go
through both packages, activations in float32 on both sides. Tolerances,
with the gaps measured on the CPU over the 4 dense smoke configs and the
ssm and hybrid ones (falcon-mamba-smoke, zamba2-smoke):

  * loss: rtol 1e-6 (measured at most 8.7e-8 relative);
  * gradients: max |g_ref - g_port| <= 1e-5 x max |g_ref| per leaf
    (measured at most 1.2e-6: the attention, scan and CE sums run in
    another order);
  * flash attention against a naive softmax: 1e-5 forward, 2e-5
    gradients, the reference's own bars;
  * AdamW: the schedule within 1 ulp-scale rtol 1e-6, new params and
    moments rtol 1e-6 / atol 1e-9 (XLA's and PyTorch's pow and sqrt round
    the bias corrections apart by up to an ulp);
  * shape tables and parameter counts: exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as RR
from repro.configs import shapes as RS
from repro.models import layers as RL
from repro.models import model as RM
from repro.optim import adamw as RA

from repro_torch import interop, tree as TT
from repro_torch.configs import registry as PR
from repro_torch.configs import twins as TR
from repro_torch.configs import shapes as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA

CPU = "cpu"
DENSE = [a for a in TR.list_archs() if TR.get_smoke_config(a).family == "dense"]
# the families whose loss and logits mirror test_smoke_forward_and_train_step
# here (the MoE family's: tests/test_torch_moe.py)
TRAINED = DENSE + [a for a in TR.list_archs()
                   if TR.get_smoke_config(a).family in ("ssm", "hybrid")]
LOSS_RTOL = 1e-6
GRAD_REL = 1e-5


@pytest.fixture
def f32_acts():
    old_r, old_t = RM.ACT_DTYPE, TM.ACT_DTYPE
    RM.ACT_DTYPE, TM.ACT_DTYPE = jnp.float32, torch.float32
    yield
    RM.ACT_DTYPE, TM.ACT_DTYPE = old_r, old_t


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_params(arch, seed=0):
    cfg = RR.get_smoke_config(arch)
    params, specs = RM.init_model(jax.random.PRNGKey(seed), cfg)
    return cfg, _np_tree(params), specs


def _tokens(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _port_loss_and_grads(cfg, params_np, tokens):
    tree = interop.model_params_from_arrays(cfg, params_np, device=CPU)
    model = TM.Model(cfg, tree)
    loss, metrics = model({"tokens": torch.from_numpy(tokens)})
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss.detach()), {n: g.numpy()
                                  for (n, _), g in zip(named, grads)}


def _ref_loss_and_grads(rcfg, params_np, tokens):
    batch = {"tokens": jnp.asarray(tokens)}
    (loss, _), grads = jax.value_and_grad(
        lambda p: RM.loss_fn(p, rcfg, batch), has_aux=True)(
            jax.tree.map(jnp.asarray, params_np))
    return float(loss), dict(TT.flatten(_np_tree(grads)))


# ----------------------------------------------------------- shape tables
@pytest.mark.parametrize("arch", RR.list_archs())
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        r, t = getattr(RR, get)(arch), getattr(TR, get)(arch)
        # the reference's fields, equal; the port's own (the published
        # Zamba2 block's) at the defaults that keep the reference's block
        assert r.__dict__ == {k: t.__dict__[k] for k in r.__dict__}
        assert {k: v for k, v in t.__dict__.items() if k not in r.__dict__
                } == {f.name: f.default for f in dataclasses.fields(t)
                      if f.name not in r.__dict__}
        assert r.param_count() == t.param_count()
        assert r.active_param_count() == t.active_param_count()
        assert r.vocab_padded == t.vocab_padded
        assert (r.d_inner, r.ssm_heads, r.q_dim, r.kv_dim) == (
            t.d_inner, t.ssm_heads, t.q_dim, t.kv_dim)
    assert RR.sub_quadratic(RR.get_config(arch)) == TR.sub_quadratic(
        TR.get_config(arch))


def test_registry_and_shapes_equal_the_reference():
    assert TR.list_archs() == RR.list_archs()
    with pytest.raises(KeyError, match="unknown arch"):
        TR.get_config("nope")
    assert {k: v.__dict__ for k, v in TS.SHAPES.items()} == {
        k: v.__dict__ for k, v in RS.SHAPES.items()}
    for arch in RR.list_archs():
        rc = RR.get_config(arch)
        for shape in RS.SHAPES.values():
            ts = TS.SHAPES[shape.name]
            assert TS.cell_is_runnable(rc.family, ts, TR.sub_quadratic(rc)) \
                == RS.cell_is_runnable(rc.family, shape, RR.sub_quadratic(rc))
    # param_count() is the reference's estimate (no biases, no final
    # norm); the tensors of the full tree add up to the real count
    full = TR.get_config("qwen2-1.5b")
    assert full.param_count() == 1_543_655_424
    meta, _ = TM.abstract_params(full)
    assert sum(x.numel() for x in TT.leaves(meta)) == 1_543_714_304


# ------------------------------------------------------------ init / specs
@pytest.mark.parametrize("arch", DENSE)
def test_init_tree_and_specs_match_the_reference(arch):
    rcfg, rparams, rspecs = _ref_params(arch)
    cfg = TR.get_smoke_config(arch)
    tparams, tspecs = TM.init_model(cfg, seed=0, device=CPU)
    rflat, tflat = TT.flatten(rparams), TT.flatten(tparams)
    assert [p for p, _ in rflat] == [p for p, _ in tflat]
    for (path, r), (_, t) in zip(rflat, tflat):
        assert r.shape == tuple(t.shape) and t.dtype == torch.float32, path
    rs = dict(TT.flatten(jax.tree.map(
        lambda s: s, rspecs, is_leaf=lambda s: isinstance(s, tuple))))
    assert rs == dict(TT.flatten(tspecs))
    meta, mspecs = TM.abstract_params(cfg)
    assert mspecs == tspecs
    assert all(m.is_meta and m.shape == t.shape for (_, m), (_, t) in zip(
        TT.flatten(meta), tflat))
    # the init's draws: truncated normals with the reference's scales
    wq = tparams["layers"]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-6
    assert torch.equal(tparams["ln_f"]["scale"], torch.ones(cfg.d_model))
    again, _ = TM.init_model(cfg, seed=0, device=CPU)
    other, _ = TM.init_model(cfg, seed=1, device=CPU)
    assert torch.equal(again["emb"]["tok"], tparams["emb"]["tok"])
    assert not torch.equal(other["emb"]["tok"], tparams["emb"]["tok"])


def test_interop_round_trip_is_exact():
    rcfg, rparams, _ = _ref_params("qwen2-1.5b")
    cfg = TR.get_smoke_config("qwen2-1.5b")
    tree = interop.model_params_from_arrays(cfg, rparams, device=CPU)
    back = interop.model_params_to_arrays(TM.Model(cfg, tree).tree())
    for (p, a), (q, b) in zip(TT.flatten(rparams), TT.flatten(back)):
        assert p == q and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    bad = dict(rparams)
    bad["ln_f"] = {"scale": np.ones(3, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        interop.model_params_from_arrays(cfg, bad, device=CPU)


# every configuration the port runs, and the JAX package's zamba2 block
PLANNED = [(a, PR.get_config(a)) for a in PR.list_archs()] + [
    ("zamba2-2.7b-twin", TR.get_config("zamba2-2.7b"))]


@pytest.mark.parametrize("cfg", [c for _, c in PLANNED],
                         ids=[a for a, _ in PLANNED])
def test_plan_orders_each_stack_and_sizes_the_cache(cfg):
    """``_plan`` at full size, on meta (nothing allocated): every layer
    once and in order; the published zamba2 block's shared calls before
    layers 6, 12, ..., 51, alternating over its two blocks; the twin's
    one block after every 6th layer; one run in the other families; and
    ``make_cache``'s k/v slots equal the plan's attention stages."""
    plan = TM._plan(cfg)
    E = cfg.attn_every
    layers, slots = [], 0
    for kind, a, b in plan:
        if kind == "call":
            layers.append(b)
            slots += 1
        elif kind == "group":
            layers += range(a * E, b * E)
            slots += b - a
        else:
            layers += range(a, b)
            slots += (b - a) * (kind == "attn")
    assert layers == list(range(cfg.num_layers))
    if cfg.hybrid_ids:
        calls = [(j, i) for kind, j, i in plan if kind == "call"]
        assert [i for _, i in calls] == [6, 12, 18, 24, 30, 36, 42, 47, 51]
        assert [j % cfg.shared_blocks for j, _ in calls] == [0, 1] * 4 + [0]
        assert {kind for kind, _, _ in plan} == {"ssm", "call"}
    elif cfg.family == "hybrid":
        assert plan == [("group", 0, 9)] and E == 6
    else:
        kind = "ssm" if cfg.family == "ssm" else "attn"
        assert plan == [(kind, 0, cfg.num_layers)]
    if cfg.family == "encoder":
        with pytest.raises(ValueError, match="no decode step"):
            TM.make_cache(cfg, 1, 8, device="meta")
    else:
        cache = TM.make_cache(cfg, 1, 8, device="meta")
        assert (cache["k"].shape[0] if "k" in cache else 0) == slots


@pytest.mark.parametrize("arch", [a for a in TR.list_archs()
                                  if TR.get_smoke_config(a).family
                                  not in ("dense", "moe", "ssm", "hybrid")])
def test_other_families_raise_naming_the_roadmap(arch):
    """The encoder and vlm families, the last two ported, raise no more:
    their trees and specs equal the reference's and cross ``interop``
    exactly both ways; only an unknown family name raises."""
    rcfg, rparams, rspecs = _ref_params(arch)
    cfg = TR.get_smoke_config(arch)
    tparams, tspecs = TM.init_model(cfg, seed=0, device=CPU)
    assert [(p, tuple(t.shape)) for p, t in TT.flatten(tparams)] == [
        (p, r.shape) for p, r in TT.flatten(rparams)]
    assert dict(TT.flatten(tspecs)) == dict(TT.flatten(jax.tree.map(
        lambda s: s, rspecs, is_leaf=lambda s: isinstance(s, tuple))))
    tree = interop.model_params_from_arrays(cfg, rparams, device=CPU)
    back = interop.model_params_to_arrays(TM.Model(cfg, tree).tree())
    for (p, a), (q, b) in zip(TT.flatten(rparams), TT.flatten(back)):
        assert p == q and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown family"):
        TM.init_model(dataclasses.replace(cfg, family="rnn"), device=CPU)


# ----------------------------------------------------- loss and gradients
@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_grads_match_the_reference(arch, f32_acts):
    rcfg, rparams, _ = _ref_params(arch)
    cfg = TR.get_smoke_config(arch)
    toks = _tokens(cfg)
    rl, rg = _ref_loss_and_grads(rcfg, rparams, toks)
    tl, tg = _port_loss_and_grads(cfg, rparams, toks)
    assert np.isfinite(tl) and abs(tl - rl) <= LOSS_RTOL * abs(rl)
    assert set(rg) == set(tg)
    for path in rg:
        scale = float(np.abs(rg[path]).max())
        gap = float(np.abs(rg[path] - tg[path]).max())
        assert gap <= GRAD_REL * max(scale, 1e-12), (path, gap, scale)


@pytest.mark.parametrize("arch", TRAINED)
def test_forward_logits_match_the_reference(arch, f32_acts):
    rcfg, rparams, _ = _ref_params(arch)
    cfg = TR.get_smoke_config(arch)
    toks = _tokens(cfg, seed=1)
    ref = np.asarray(RM.forward_logits(jax.tree.map(jnp.asarray, rparams),
                                       rcfg, {"tokens": jnp.asarray(toks)}))
    tree = interop.model_params_from_arrays(cfg, rparams, device=CPU)
    with torch.no_grad():
        got = TM.forward_logits(tree, cfg,
                                {"tokens": torch.from_numpy(toks)}).numpy()
    live = ref > -1e29
    np.testing.assert_array_equal(live, got > -1e29)
    np.testing.assert_allclose(got[live], ref[live], rtol=1e-4, atol=1e-4)


def test_loss_mask_and_remat_do_not_change_the_loss(f32_acts):
    import dataclasses
    rcfg, rparams, _ = _ref_params("qwen2-1.5b")
    cfg = TR.get_smoke_config("qwen2-1.5b")
    toks = _tokens(cfg)
    mask = np.ones(toks.shape, bool)
    mask[:, ::3] = False
    rl, _ = RM.loss_fn(jax.tree.map(jnp.asarray, rparams), rcfg,
                       {"tokens": jnp.asarray(toks),
                        "loss_mask": jnp.asarray(mask)})
    tree = interop.model_params_from_arrays(cfg, rparams, device=CPU)
    tl, _ = TM.loss_fn(tree, cfg, {"tokens": torch.from_numpy(toks),
                                   "loss_mask": torch.from_numpy(mask)})
    assert abs(float(tl) - float(rl)) <= LOSS_RTOL * abs(float(rl))
    # recomputation in backward gives the same gradients, bit for bit
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        _, g = _port_loss_and_grads(c, rparams, toks)
        out.append(g)
    for path in out[0]:
        np.testing.assert_array_equal(out[0][path], out[1][path])


# --------------------------------------------------------- flash attention
def _naive(q, k, v, causal):
    B, S, H, hd = q.shape
    K = k.shape[2]
    qn = q.reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgh,bckh->bqkgc", qn, k) / np.sqrt(hd)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool))
        s = torch.where(mask[None, :, None, None, :], s, -1e30)
    p = torch.softmax(s, -1)
    return torch.einsum("bqkgc,bckh->bqkgh", p, v).reshape(B, S, H, hd)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grad_matches_naive_and_reference(causal):
    B, S, H, K, hd = 2, 64, 4, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = TL.chunked_attention(tq, tk, tv, causal=causal, chunk=16)
    ref = _naive(tq, tk, tv, causal)
    assert float((out - ref).detach().abs().max()) < 1e-5
    g1 = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    g2 = torch.autograd.grad(torch.sin(ref).sum(), (tq, tk, tv))
    for a, b in zip(g1, g2):
        assert float((a - b).abs().max()) < 2e-5
    # and against the reference's custom-VJP flash attention
    jout = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, chunk=16)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    jg = jax.grad(lambda a, b, c: jnp.sum(jnp.sin(RL.chunked_attention(
        a, b, c, causal=causal, chunk=16))), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(g1, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=2e-6)


@pytest.mark.parametrize("q_offset,valid", [(0, 40), (24, 64)])
def test_flash_attention_offsets_match_the_reference(q_offset, valid):
    """A query offset and a kv valid length (the prefill/decode knobs)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 32, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, 64, 2, 8)).astype(np.float32)
            for _ in range(2))
    for causal in (True, False):
        want = np.asarray(RL.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            chunk=16, q_offset=q_offset, kv_valid_len=valid))
        got = TL.chunked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, chunk=16, q_offset=q_offset, kv_valid_len=valid)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_attention_rejects_a_sequence_off_the_chunk():
    x = torch.zeros((1, 24, 2, 8))
    with pytest.raises(ValueError, match="divide"):
        TL.chunked_attention(x, x, x, causal=True, chunk=16)


# ------------------------------------------------------------------ AdamW
def test_schedule_matches_the_reference():
    for cfg in (RA.OptConfig(), RA.OptConfig(warmup_steps=3, total_steps=60,
                                             peak_lr=5e-3)):
        tcfg = TA.OptConfig(**cfg.__dict__)
        for step in (0, 1, 2, 3, 4, 50, 99, 100, 101, 5000, 10_000, 20_000):
            r = float(RA.schedule(cfg, jnp.int32(step)))
            t = float(TA.schedule(tcfg, torch.tensor(step,
                                                     dtype=torch.int32)))
            assert t == pytest.approx(r, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_apply_updates_matches_the_reference(clip):
    rng = np.random.default_rng(3)
    shapes = {"a": {"w": (3, 16, 8), "s": (3, 16)}, "b": (32,),
              "c": (8, 8)}
    def tree(scale):
        return TT.unflatten((p, (scale * rng.standard_normal(s)).astype(
            np.float32)) for p, s in TT.flatten(shapes))
    params, grads = tree(1.0), tree(0.5)
    m, v = tree(0.1), TT.tree_map(np.abs, tree(0.01))
    cfg = RA.OptConfig(warmup_steps=3, total_steps=60, peak_lr=5e-3,
                       clip_norm=clip)
    rstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v), "step": jnp.int32(4)}
    rp, rs, rm = RA.apply_updates(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, grads), rstate,
                                  cfg)
    tt = lambda t: TT.tree_map(torch.from_numpy, t)
    tstate = {"m": tt(m), "v": tt(v),
              "step": torch.tensor(4, dtype=torch.int32)}
    tp, ts, tm = TA.apply_updates(tt(params), tt(grads), tstate,
                                  TA.OptConfig(**cfg.__dict__))
    assert int(ts["step"]) == int(rs["step"]) == 5
    assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                   rel=1e-6)
    assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    for name, r, t in (("params", rp, tp), ("m", rs["m"], ts["m"]),
                       ("v", rs["v"], ts["v"])):
        for (path, a), (_, b) in zip(TT.flatten(_np_tree(r)),
                                     TT.flatten(t)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-9,
                                       err_msg=f"{name} {path}")
    # decay reaches exactly the ndim >= 2 leaves (stacked norms included)
    zero = TT.tree_map(torch.zeros_like, tt(grads))
    zp, _, _ = TA.apply_updates(tt(params), zero, {
        "m": TT.tree_map(torch.zeros_like, zero),
        "v": TT.tree_map(torch.zeros_like, zero),
        "step": torch.tensor(4, dtype=torch.int32)}, TA.OptConfig(
            **cfg.__dict__))
    for (path, a), (_, b) in zip(TT.flatten(params), TT.flatten(zp)):
        assert np.array_equal(a, b.numpy()) == (a.ndim < 2), path


def test_init_opt_state_and_global_norm():
    params = {"a": torch.ones((2, 3)), "b": {"c": torch.full((4,), 2.0)}}
    st = TA.init_opt_state(params)
    assert int(st["step"]) == 0 and st["step"].dtype == torch.int32
    assert all(float(x.abs().sum()) == 0 for x in TT.leaves(st["m"]))
    assert TT.flatten(st["v"])[0][0] == "a"
    assert float(TA.global_norm(params)) == pytest.approx(np.sqrt(6 + 16))
