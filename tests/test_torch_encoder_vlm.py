"""Parity of the port's encoder and vlm families with the JAX package, on
the CPU, at hubert-smoke and internvl2-smoke.

The same parameters (the reference's init, carried over by
``interop.model_params_from_arrays``) and the same numpy inputs (frames,
labels, tokens, patches from a seeded numpy generator) go through both
packages, activations in float32 on both sides. Tolerances, as
tests/test_torch_models.py and tests/test_torch_decode.py hold the other
families:

  * loss: rtol 1e-6; gradients: max |g_ref - g_port| <= 1e-5 x max
    |g_ref| per leaf (the encoder's unused token embedding: zeros on both);
  * forward logits, prefill logits and k/v caches, every ``serve_step``:
    1e-5 x the reference's largest |value|;
  * decode against the full forward: the reference tests' 5e-3 x
    max(scale, 1); greedy tokens equal;
  * three train steps against a single-device JAX loop: losses rtol 1e-5,
    params rtol 1e-4 / atol 1e-4 (the other families' bars);
  * shapes, dtypes, tokens, labels and launch counts: exact. The stub
    frontends' draws come from torch's generator, not threefry: their
    shapes, dtypes and determinism are exact, their values standard
    normal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as RR
from repro.configs import shapes as RS
from repro.launch import steps as RSt
from repro.launch import train as RTr
from repro.models import model as RM
from repro.optim import adamw as RA

from repro_torch import interop, tree as TT
from repro_torch.configs import registry as TR
from repro_torch.configs import shapes as TS
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import blockselect as KB
from repro_torch.kernels import compact as KC
from repro_torch.kernels import seeds as KS
from repro_torch.launch import mesh as TMe
from repro_torch.launch import serve as TSv
from repro_torch.launch import steps as TSt
from repro_torch.launch import train as TTr
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA

CPU = "cpu"
ARCHS = ["hubert-xlarge", "internvl2-76b"]
VLM = "internvl2-76b"
REL = 1e-5
GRAD_REL = 1e-5


@pytest.fixture
def f32_acts():
    old_r, old_t = RM.ACT_DTYPE, TM.ACT_DTYPE
    RM.ACT_DTYPE, TM.ACT_DTYPE = jnp.float32, torch.float32
    yield
    RM.ACT_DTYPE, TM.ACT_DTYPE = old_r, old_t


def _setup(arch, seed=0):
    """(reference cfg, port cfg, reference params (numpy), port tree)."""
    rcfg, cfg = RR.get_smoke_config(arch), TR.get_smoke_config(arch)
    params, _ = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    pn = jax.tree.map(np.asarray, params)
    return rcfg, cfg, pn, interop.model_params_from_arrays(cfg, pn,
                                                           device=CPU)


def _batch(cfg, B=2, S=32, seed=0):
    """A numpy batch of S positions: an encoder's frames and labels, a
    vlm's patches and S - frontend_tokens text tokens."""
    rng = np.random.default_rng(seed)
    emb = lambda n: rng.standard_normal((B, n, cfg.d_model)).astype(
        np.float32)
    toks = lambda n: rng.integers(0, cfg.vocab_size, (B, n)).astype(
        np.int32)
    if cfg.family == "encoder":
        return {"frames": emb(S), "labels": toks(S)}
    P = cfg.frontend_tokens
    return {"patches": emb(P), "tokens": toks(S - P)}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _th(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    live = want > -1e29          # padded vocab rows are -1e30 on both
    scale = float(np.abs(np.where(live, want, 0)).max())
    gap = float(np.abs(np.where(live, got - want, 0)).max())
    assert gap <= rel * max(scale, 1e-12), (what, gap, scale)


# ----------------------------------------------------- loss and gradients
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, f32_acts):
    rcfg, cfg, pn, tree = _setup(arch)
    batch = _batch(cfg)
    rp = jax.tree.map(jnp.asarray, pn)
    ref_loss = jax.jit(lambda p, b: RM.loss_fn(p, rcfg, b)[0])
    rl, rg = jax.jit(jax.value_and_grad(ref_loss))(rp, _jx(batch))
    rg = dict(TT.flatten(jax.tree.map(np.asarray, rg)))
    model = TM.Model(cfg, tree)
    tl, _ = model(_th(batch))
    named = list(model.named_parameters())
    tg = torch.autograd.grad(tl, [p for _, p in named], allow_unused=True,
                             materialize_grads=True)
    tg = {n: g.numpy() for (n, _), g in zip(named, tg)}
    tl = tl.detach()
    assert np.isfinite(float(tl))
    assert abs(float(tl) - float(rl)) <= 1e-6 * abs(float(rl))
    assert set(rg) == set(tg)
    for path in rg:
        scale = float(np.abs(rg[path]).max())
        gap = float(np.abs(rg[path] - tg[path]).max())
        assert gap <= GRAD_REL * max(scale, 1e-12), (path, gap, scale)
    if cfg.family == "encoder":     # the frames bypass the embedding
        assert not tg["emb.tok"].any() and not rg["emb.tok"].any()
    # neither family reads a loss_mask, on either side
    masked = dict(batch, loss_mask=np.zeros(
        next(iter(batch.values())).shape[:2], np.int32))
    assert float(TM.loss_fn(tree, cfg, _th(masked))[0]) == float(tl)
    assert float(ref_loss(rp, _jx(masked))) == float(rl)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_the_reference(arch, f32_acts):
    rcfg, cfg, pn, tree = _setup(arch)
    batch = _batch(cfg, seed=1)
    want = RM.forward_logits(jax.tree.map(jnp.asarray, pn), rcfg,
                             _jx(batch))
    got = TM.forward_logits(tree, cfg, _th(batch))
    assert got.shape == (2, 32, cfg.vocab_padded)
    _close(got, want, what=arch)


def test_vlm_labels_and_mask_are_text_only():
    _, cfg, _, tree = _setup(VLM)
    batch = _th(_batch(cfg))
    x, pos, labels, mask = TM._inputs_to_hidden(tree, cfg, batch)
    P, toks = cfg.frontend_tokens, batch["tokens"]
    assert x.shape == (2, 32, cfg.d_model) and x.dtype == TM.ACT_DTYPE
    assert torch.equal(pos[0], torch.arange(32))
    assert torch.equal(labels[:, P - 1:-1], toks)
    assert not labels[:, :P - 1].any() and not labels[:, -1].any()
    want = torch.zeros(32, dtype=torch.bool)
    want[P:-1] = True
    assert torch.equal(mask, want.expand(2, 32))


# ------------------------------------------------------- prefill / decode
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_the_reference(arch, f32_acts):
    rcfg, cfg, pn, tree = _setup(arch)
    batch = _batch(cfg, S=16, seed=2)
    rl, rc = RM.prefill(jax.tree.map(jnp.asarray, pn), rcfg, _jx(batch))
    tl, tc = TM.prefill(tree, cfg, _th(batch))
    _close(tl, rl, what="prefill logits")
    assert set(tc) == set(rc)
    for name in rc:                 # [L, B, S, K, hd], the same layout
        assert tc[name].dtype == torch.float32
        _close(tc[name], rc[name], what=name)
    if cfg.family == "encoder":
        assert tc == {}
        with pytest.raises(ValueError, match="no decode step"):
            TM.make_cache(cfg, 2, 16, device=CPU)
        with pytest.raises(ValueError, match="no decode step"):
            TM.serve_step(tree, cfg, torch.zeros(2, dtype=torch.int32), {},
                          16)


def test_vlm_serve_step_matches_the_reference(f32_acts):
    """Prefill [8 patches | 8 tokens], then 4 steps at index
    frontend_tokens + 8 + t on both sides: logits and caches."""
    rcfg, cfg, pn, tree = _setup(VLM)
    batch = _batch(cfg, S=16, seed=3)
    rp = jax.tree.map(jnp.asarray, pn)
    _, rc = RM.prefill(rp, rcfg, _jx(batch))
    _, tc = TM.prefill(tree, cfg, _th(batch))
    rc, tc = RM.grow_cache(rcfg, rc, 4), TM.grow_cache(cfg, tc, 4)
    step = jax.jit(lambda p, t, c, i: RM.serve_step(p, rcfg, t, c, i))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 2))
    for t in range(4):
        idx = cfg.frontend_tokens + 8 + t
        rl, rc = step(rp, jnp.asarray(toks[t], jnp.int32), rc,
                      jnp.int32(idx))
        tl, tc = TM.serve_step(tree, cfg, torch.from_numpy(
            toks[t].astype(np.int32)), tc, idx)
        _close(tl, rl, what=f"step {t} logits")
        for name in ("k", "v"):
            _close(tc[name], rc[name], what=f"step {t} {name}")


def _vlm_decode_errors(cfg, tree, batch):
    """Prefill [patches | the first token], then serve_step at index
    frontend_tokens + t for every text position t (re-decoding t = 0):
    (max step error, prefill error, scale) against forward_logits."""
    P, S = cfg.frontend_tokens, batch["tokens"].shape[1]
    full = TM.forward_logits(tree, cfg, batch)
    V = cfg.vocab_size
    last, cache = TM.prefill(tree, cfg, {"patches": batch["patches"],
                                         "tokens": batch["tokens"][:, :1]})
    perr = float((last[:, :V] - full[:, P, :V]).abs().max())
    cache = TM.grow_cache(cfg, cache, S - 1)
    err = 0.0
    for t in range(S):
        logits, cache = TM.serve_step(tree, cfg, batch["tokens"][:, t],
                                      cache, P + t)
        err = max(err, float((logits[:, :V] - full[:, P + t, :V]).abs()
                             .max()))
    return err, perr, float(full[..., :V].abs().max())


def test_vlm_decode_matches_the_full_forward(f32_acts):
    """The reference's test_smoke_decode_consistency leaves the vlm out;
    the port holds it: decode after a patch prefill equals the full
    forward over [patches | text] within 5e-3 x max(scale, 1)."""
    _, cfg, _, tree = _setup(VLM, seed=1)
    err, perr, scale = _vlm_decode_errors(cfg, tree, _th(_batch(cfg,
                                                                seed=5)))
    assert np.isfinite(scale) and scale > 0
    assert err <= 5e-3 * max(scale, 1.0) and perr <= 5e-3 * max(scale, 1.0)


# --------------------------------------------------------- steps / batches
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    rcfg, cfg = RR.get_config(arch), TR.get_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        want = RSt.input_specs(rcfg, RS.SHAPES[name])
        got = TSt.input_specs(cfg, TS.SHAPES[name])
        assert set(got) == set(want), name
        for k, spec in want.items():
            assert got[k].is_meta and tuple(got[k].shape) == spec.shape
            assert str(got[k].dtype) == f"torch.{spec.dtype}", (name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_matches_the_reference(arch):
    cfg = TR.get_smoke_config(arch)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                      global_batch=4)
    raw = {"tokens": np.random.default_rng(6).integers(
        0, 1000, (4, 32)).astype(np.int32)}
    want = RTr.make_batch(RR.get_smoke_config(arch), raw, dcfg)
    got = TTr.make_batch(cfg, raw, dcfg, CPU)
    again = TTr.make_batch(cfg, raw, dcfg, CPU)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype) == f"torch.{w.dtype}", k
        assert torch.equal(got[k], again[k]), k   # the same every step
    stub = "frames" if cfg.family == "encoder" else "patches"
    exact = "labels" if cfg.family == "encoder" else "tokens"
    np.testing.assert_array_equal(got[exact].numpy(), np.asarray(want[exact]))
    x = got[stub].to(torch.float32)
    assert abs(float(x.mean())) < 0.1 and abs(float(x.std()) - 1) < 0.1
    other = TTr._stub_embeddings(tuple(x.shape), 1 - (stub == "patches"),
                                 CPU)
    assert not torch.equal(other, got[stub])


# ------------------------------------------------------------- serve.main
def test_serve_main_vlm_chunk_rule_raises_before_any_work(monkeypatch):
    def no_init(*a, **kw):
        raise AssertionError("the model was built before the check")
    monkeypatch.setattr(TM, "init_model", no_init)
    with pytest.raises(ValueError, match="8 \\+ 12 = 20 must be at most "
                       "attn_chunk = 16 or a multiple of it"):
        TSv.main(["--device", "cpu", "--smoke", "--arch", VLM,
                  "--prompt-len", "12"])


def _recording_steps(monkeypatch):
    """serve_step's indices, recorded as serve.main calls it."""
    seen, step = [], TM.serve_step

    def rec(params, cfg, tokens, cache, index):
        seen.append(int(index))
        return step(params, cfg, tokens, cache, index)
    monkeypatch.setattr(TM, "serve_step", rec)
    return seen


def test_serve_main_vlm_generates_the_full_forward_greedy_tokens(
        f32_acts, monkeypatch):
    """serve.main --arch internvl2-76b --smoke: its greedy tokens are the
    argmax of the full forward over [patches | prompt + generated], and
    it decodes from frontend_tokens + prompt_len."""
    B, Pl, G, seed = 2, 8, 5, 4
    seen = _recording_steps(monkeypatch)
    out = TSv.main(["--device", "cpu", "--smoke", "--arch", VLM, "--batch",
                    str(B), "--prompt-len", str(Pl), "--gen", str(G),
                    "--seed", str(seed)])
    cfg = TR.get_smoke_config(VLM)
    P = cfg.frontend_tokens
    assert seen == [P + Pl + t for t in range(G - 1)]
    toks = out["tokens"]
    assert toks.shape == (B, G) and out["stats"][0, 0] == B * (Pl + G)
    tree, _ = TM.init_model(cfg, seed=seed, device=CPU)
    gen = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, Pl), generator=gen,
                            dtype=torch.int32)
    patches = torch.randn((B, P, cfg.d_model), generator=gen).to(
        torch.bfloat16)
    # causal: the positions after the last pick change none of them; the
    # zeros pad the sequence to a multiple of attn_chunk
    text = torch.cat([prompts, torch.from_numpy(toks[:, :-1]), torch.zeros(
        (B, 32 - P - Pl - G + 1), dtype=torch.int32)], dim=1)
    full = TM.forward_logits(tree, cfg, {"tokens": text, "patches": patches})
    picks = torch.argmax(full[:, P + Pl - 1:P + Pl - 1 + G,
                              :cfg.vocab_size], -1)
    np.testing.assert_array_equal(picks.numpy(), toks)


def test_reference_serve_index_writes_inside_the_prompt(f32_acts,
                                                        monkeypatch):
    """The reference's serve.py decodes a vlm from ``prompt_len``: its
    first step writes k/v into slot prompt_len, a text token's slot
    inside the [patches | prompt] prefill, and its logits miss the full
    forward's. At frontend_tokens + prompt_len, the index the port's
    serve.main uses, the same reference model code leaves the prompt's
    slots as they were and matches the full forward."""
    rcfg, cfg, pn, _ = _setup(VLM)
    Pl, P = 8, cfg.frontend_tokens
    batch = _jx(_batch(cfg, S=P + Pl, seed=7))
    rp = jax.tree.map(jnp.asarray, pn)
    last, cache = RM.prefill(rp, rcfg, batch)
    cache = RM.grow_cache(rcfg, cache, 2)
    tok = jnp.argmax(last, -1).astype(jnp.int32)
    # causal: position P + Pl sees none of the zeros after it, which pad
    # the sequence to a multiple of attn_chunk
    full = RM.forward_logits(rp, rcfg, {
        "patches": batch["patches"],
        "tokens": jnp.concatenate([batch["tokens"], tok[:, None], jnp.zeros(
            (2, 15), jnp.int32)], 1)})[:, P + Pl]
    pre = np.asarray(cache["k"])
    outs = {}
    for idx in (Pl, P + Pl):        # the reference serve.py's, the port's
        logits, c = RM.serve_step(rp, rcfg, tok, jax.tree.map(jnp.copy,
                                                              cache), idx)
        k = np.asarray(c["k"])
        outs[idx] = (np.abs(np.asarray(logits) - np.asarray(full)).max(),
                     np.array_equal(k[:, :, :P + Pl],
                                            pre[:, :, :P + Pl]))
    scale = float(np.abs(np.asarray(full)).max())
    assert not outs[Pl][1] and outs[Pl][0] > 1e-2 * scale
    assert outs[P + Pl][1] and outs[P + Pl][0] <= REL * scale
    seen = _recording_steps(monkeypatch)
    TSv.main(["--device", "cpu", "--smoke", "--arch", VLM, "--batch", "2",
              "--prompt-len", str(Pl), "--gen", "3"])
    assert min(seen) == P + Pl


# -------------------------------------------------------------- training
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


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_a_jax_loop_and_count_launches(
        arch, f32_acts, monkeypatch):
    """loss_fn, jax.grad and apply_updates on one device against
    make_train_step with the sampled exchange at one pod (every leaf of
    >= 1024 elements sampled, returned as it came) and the telemetry
    fold; each step calls K1 and K2 once per sampled leaf and the fold
    (1, 2, 1)."""
    rcfg, cfg, pn, tree = _setup(arch)
    ropt = RA.OptConfig(total_steps=60, warmup_steps=3, peak_lr=5e-3)
    batches = [_batch(cfg, B=4, S=16, seed=10 + i) for i in range(3)]

    @jax.jit
    def ref_step(params, opt, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: RM.loss_fn(p, rcfg, batch), has_aux=True)(params)
        new_p, new_opt, _ = RA.apply_updates(params, grads, opt, ropt)
        return new_p, new_opt, loss, grads

    rparams = jax.tree.map(jnp.asarray, pn)
    ropt_state = RA.init_opt_state(rparams)
    rlosses, resolved = [], {}
    for b in batches:
        rparams, ropt_state, loss, grads = ref_step(rparams, ropt_state,
                                                    _jx(b))
        rlosses.append(float(loss))
        for p, g in TT.flatten(jax.tree.map(np.asarray, grads)):
            ok = (np.abs(g) >= GRAD_REL * np.abs(g).max()) | (g == 0)
            resolved[p] = resolved.get(p, True) & ok
    mesh = TMe.Mesh((1, 1, 1), ("pod", "data", "model"), device=CPU)
    step, _ = TSt.make_train_step(cfg, TA.OptConfig(**ropt.__dict__), mesh,
                                  compress=dict(k=256, min_size=1024),
                                  telemetry=TTr.TEL_SPEC)
    from repro_torch.core import multisketch_empty
    state = {"params": tree, "opt": TA.init_opt_state(tree),
             "tel": multisketch_empty(TTr.TEL_SPEC, device=CPU)}
    nleaf = sum(1 for t in TT.leaves(tree) if t.numel() >= 1024)
    assert nleaf >= 8
    counts = _counting(monkeypatch)
    tlosses = []
    for b in batches:
        before = dict(counts)
        state, m = step(state, _th(b))
        tlosses.append(float(m["loss"]))
        assert {k: counts[k] - before[k] for k in counts} == {
            "seeds": nleaf + 1, "blockselect": nleaf + 2, "compact": 1}
    np.testing.assert_allclose(tlosses, rlosses, rtol=1e-5)
    for (p, a), (_, b) in zip(TT.flatten(jax.tree.map(np.asarray, rparams)),
                              TT.flatten(state["params"])):
        # an element whose nonzero gradient lies under the gradient bar in
        # some step is rounding noise there, which Adam's normalised step
        # scales up: its update is not held (at most 1 in 100 of a leaf;
        # exact zeros, the padded vocab rows and an encoder's token
        # embedding, are held)
        ok = resolved[p]
        assert ok.mean() >= 0.99, (p, ok.mean())
        np.testing.assert_allclose(b.numpy()[ok], a[ok], rtol=1e-4,
                                   atol=1e-4, err_msg=p)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_trains_with_the_exchange(arch, monkeypatch):
    """train.main --smoke --compress: 2 steps, finite losses, the plain
    path's calls per step (1, 2, 1): the telemetry fold alone, every smoke
    leaf being under the exchange's 65,536 elements."""
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
        ["--device", "cpu", "--smoke", "--arch", arch, "--steps", "2",
         "--batch", "4", "--seq", "32", "--mesh", "1x1x1", "--compress",
         "--importance-sampling", "--log-every", "1"], callback=cb)
    assert sorted(seen) == [1, 2]
    for loss, delta in seen.values():
        assert np.isfinite(loss) and loss > 0
        assert delta == {"seeds": 1, "blockselect": 2, "compact": 1}
    assert int(state["opt"]["step"]) == 2
    assert int(state["tel"].valid.sum()) == 8
