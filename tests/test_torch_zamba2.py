"""The port's published Zamba2 block (``models/model.py``, ``cfg.hybrid_ids``)
against the plain reference ``bench/reference/zamba2.py`` on the CPU, at
the smoke size (d 64, 4 heads of 32, 2 shared blocks, adapter rank 8, 8
layers, the shared calls before layers 2, 5 and 7), on the benchmark's
seeded weights (``bench/weights.py``), activations in float32:

  * the loss and every leaf's gradient, rtol 1e-4 (of each leaf's largest
    reference gradient: the port's attention runs K7's chunked loop, its
    SSD the chunked scan, the reference both over the whole square);
  * prefill, then decode through the cache, against the reference's
    full-forward logits, rtol 1e-4 of the largest logit;
  * ``shared.calls`` (one a shared call, in the forward alone) against the
    ids, and the ``mamba`` and ``shared`` spans, forward and backward;
  * planted faults, each of which the comparison must catch: the
    embedding left out of the [h, e] concatenation, the adapters dropped,
    blocks A and B swapped, the softmax scale 1/sqrt(head_dim), and t_i
    added to the residual instead of the Mamba input;
  * the grouped SSD (``mamba.SSD_GROUP``) against the one-by-one scan;
  * the default fields give the block of the JAX package, and the
    published block refuses a ``model`` axis over 1.
"""
import dataclasses
import math
import types

import pytest
import torch

from bench import weights as Wt
from bench.reference import zamba2 as Ref
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs import zamba2_2_7b as Z
from repro_torch.models import layers as TL
from repro_torch.models import mamba as M
from repro_torch.models import model as TM
from repro_torch.telemetry import spans

CPU = torch.device("cpu")
SEED = 2 ** 31 + 7
RTOL = 1e-4


@pytest.fixture(autouse=True)
def f32_acts(monkeypatch):
    monkeypatch.setattr(TM, "ACT_DTYPE", torch.float32)


def _rcfg(cfg):
    return types.SimpleNamespace(**dataclasses.asdict(cfg),
                                 d_inner=cfg.d_inner)


def _weights(cfg, seed=SEED):
    abstract, _ = TM.abstract_params(cfg)
    shapes = {p: tuple(t.shape) for p, t in T.flatten(abstract)}
    return Wt.draw_all(shapes, seed, CPU)


def _tokens(cfg, B=2, S=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g)


def _port(cfg, W, tokens):
    """(loss, {path: gradient}) of the port."""
    leaves = {p: t.clone().requires_grad_() for p, t in W.items()}
    loss, _ = TM.loss_fn(T.unflatten(leaves.items()), cfg,
                         {"tokens": tokens})
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return float(loss.detach()), dict(zip(leaves, grads))


def _reference(cfg, W, tokens):
    leaves = {p: t.clone().requires_grad_() for p, t in W.items()}
    loss, _ = Ref.loss(leaves, _rcfg(cfg), tokens)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def _gap(port, ref):
    """The worst relative gap: the loss's, and each leaf gradient's over
    its largest reference element."""
    (pl, pg), (rl, rg) = port, ref
    gaps = {"loss": abs(pl - rl) / abs(rl)}
    for p in rg:
        scale = max(float(rg[p].abs().max()), 1e-30)
        gaps[p] = float((pg[p] - rg[p]).abs().max()) / scale
    return max(gaps.values()), gaps


@pytest.fixture(scope="module")
def case():
    cfg = TR.get_smoke_config("zamba2-2.7b")
    W = _weights(cfg)
    tokens = _tokens(cfg)
    return cfg, W, tokens, _reference(cfg, W, tokens)


def test_the_smoke_config_is_the_published_block_cut_down(case):
    cfg = case[0]
    assert cfg.hybrid_ids == (2, 5, 7) and cfg.shared_blocks == 2
    assert cfg.attn_in == 2 * cfg.d_model and cfg.adapter_rank == 8
    assert cfg.q_dim == 2 * cfg.d_model
    assert cfg.attn_scale == pytest.approx((cfg.head_dim / 2) ** -0.5)
    full = TR.get_config("zamba2-2.7b")
    abstract, _ = TM.abstract_params(full)
    shapes = dict((p, tuple(t.shape)) for p, t in T.flatten(abstract))
    assert shapes["shared.attn.wq"] == (2, 5120, 5120)
    assert shapes["shared.attn.wo"] == (2, 5120, 2560)
    assert shapes["shared.mlp.wg"] == (2, 2560, 10240)
    assert shapes["adapter.wa"] == (9, 2560, 128)
    assert shapes["adapter.wg"] == (9, 128, 10240)
    assert shapes["proj.w"] == (9, 2560, 2560)
    assert "emb.out" not in shapes
    assert sum(math.prod(s) for s in shapes.values()) == 2_662_214_560


def test_loss_and_every_gradient_match_the_reference(case):
    cfg, W, tokens, ref = case
    worst, gaps = _gap(_port(cfg, W, tokens), ref)
    assert worst <= RTOL, sorted(gaps.items(), key=lambda x: -x[1])[:3]
    # every leaf of the tree takes a gradient
    assert all(float(g.abs().max()) > 0 for g in ref[1].values())


def test_prefill_then_decode_matches_the_reference_forward(case):
    cfg, W, tokens, _ = case
    with torch.no_grad():
        want = Ref.logits(W, _rcfg(cfg), tokens)
        scale = float(want.abs().max())
        tree = T.unflatten(W.items())
        P = 16
        got, cache = TM.prefill(tree, cfg, {"tokens": tokens[:, :P]})
        assert cache["k"].shape == (3, 2, P, 4, 32)
        cache = TM.grow_cache(cfg, cache, tokens.shape[1] - P)
        steps = [got]
        for t in range(P, tokens.shape[1]):
            got, cache = TM.serve_step(tree, cfg, tokens[:, t], cache, t)
            steps.append(got)
    for i, got in enumerate(steps):
        gap = float((got[:, :cfg.vocab_size] - want[:, P - 1 + i]).abs()
                    .max())
        assert gap <= RTOL * scale, (P - 1 + i, gap, scale)


def test_shared_calls_counter_and_spans(case):
    cfg, W, tokens, _ = case
    spans.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("train.step", "cpu"):
            _port(cfg, W, tokens)
    calls = sum(c.value for c in spans.counts() if c.name == "shared.calls")
    assert calls == len(cfg.hybrid_ids)
    found = spans.spans()
    named = lambda n: [s for s in found if s.name == n]
    # per Mamba layer: its forward, remat's recompute and its backward
    assert len(named("mamba")) == 3 * cfg.num_layers
    assert len(named("shared")) == 3 * len(cfg.hybrid_ids)
    # a backward span holds the recompute's forward span
    by = {i: s for i, s in enumerate(found)}
    assert any(s.name == "mamba" and s.parent >= 0
               and by[s.parent].name == "mamba" for s in found)
    assert all(s.end_s is not None for s in found)
    spans.reset()


def _fault_e_left_out(monkeypatch, cfg, W):
    held = TM._shared_call
    monkeypatch.setattr(TM, "_shared_call", lambda x, e, *a: held(
        x, torch.zeros_like(e), *a))
    return cfg, W


def _fault_adapters_dropped(monkeypatch, cfg, W):
    held = TL.apply_mlp
    monkeypatch.setattr(TL, "apply_mlp", lambda p, x, c, adapter=None:
                        held(p, x, c))
    return cfg, W


def _fault_blocks_swapped(monkeypatch, cfg, W):
    return cfg, {p: t.flip(0) if p.startswith("shared.") else t
                 for p, t in W.items()}


def _fault_scale_of_the_head_dim(monkeypatch, cfg, W):
    return dataclasses.replace(cfg, attn_scale=0.0), W


def _fault_t_into_the_residual(monkeypatch, cfg, W):
    held = TM._ssm_layer

    def layer(lp, x, c, state=None, return_state=False, sh=None, dims=None,
              t=None):
        return held(lp, x if t is None else x + t, c, state, return_state,
                    sh, dims)
    monkeypatch.setattr(TM, "_ssm_layer", layer)
    return cfg, W


@pytest.mark.parametrize("fault", [
    _fault_e_left_out, _fault_adapters_dropped, _fault_blocks_swapped,
    _fault_scale_of_the_head_dim, _fault_t_into_the_residual],
    ids=lambda f: f.__name__[len("_fault_"):])
def test_planted_faults_fail_the_comparison(case, monkeypatch, fault):
    cfg, W, tokens, ref = case
    fcfg, fW = fault(monkeypatch, cfg, W)
    worst, _ = _gap(_port(fcfg, fW, tokens), ref)
    assert worst > 100 * RTOL, worst


@pytest.mark.parametrize("S,group", [(64, 2), (64, 8), (32, 4)])
def test_grouped_ssd_chunks_match_the_scan_one_by_one(monkeypatch, S,
                                                      group):
    """``SSD_GROUP`` chunks of the SSD at once (``_m2_chunks``) give the
    one-by-one scan's (a group of 1) output, input gradient and final
    state to fp32 rounding (the sums run in another order)."""
    cfg = TR.get_smoke_config("zamba2-2.7b")
    p, _ = M.init_mamba2(TL.Init(CPU, 0), cfg)
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(S))
    out = []
    for g in (1, group):
        monkeypatch.setattr(M, "SSD_GROUP", g)
        xg = x.clone().requires_grad_()
        y, _ = M.apply_mamba2(p, xg, cfg)
        grad, = torch.autograd.grad(y.square().sum(), xg)
        with torch.no_grad():
            _, st = M.apply_mamba2(p, x, cfg, return_state=True)
        out.append((y.detach(), grad, st["h"]))
    for a, b in zip(*out):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())


def test_default_fields_keep_the_jax_package_block():
    twin = Z.TWIN
    assert not twin.published_hybrid and twin.attn_in == twin.d_model
    assert twin.hybrid_ids == () and twin.shared_blocks == 1
    assert twin.attn_scale == 0.0 and twin.gelu_approx == "tanh"
    abstract, _ = TM.abstract_params(Z.TWIN_SMOKE)
    paths = [p for p, _ in T.flatten(abstract)]
    assert not any(p.startswith(("adapter.", "proj.")) for p in paths)
    assert abstract["shared"]["attn"]["wq"].shape == (64, 64)


def test_published_block_refuses_a_model_axis(case):
    """The walk refuses it in training, prefill and decode alike."""
    cfg, W, tokens, _ = case
    sh = types.SimpleNamespace(tp=True, m=2)
    x = torch.zeros(2, 32, cfg.d_model)
    positions = torch.zeros(2, 32, dtype=torch.long)
    for mode in ({}, {"keep": True},
                 {"cache": TM.make_cache(cfg, 2, 32, device=CPU),
                  "index": 0}):
        with pytest.raises(ValueError, match="tensor-parallel"):
            TM._walk(T.unflatten(W.items()), cfg, [x], positions, sh,
                     **mode)
