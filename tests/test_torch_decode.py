"""Parity of the port's decode path with the JAX package, on the CPU:
``decode_attention``, the cache branch of ``apply_attention``,
``make_cache`` / ``grow_cache``, ``prefill``, ``serve_step``, the step
factories, ``cache_pspecs`` and ``launch/serve.py`` (mirrors
tests/test_models.py's ``test_smoke_decode_consistency`` and
``test_prefill_then_decode`` for the dense, MoE, ssm and hybrid
families; the SSM blocks themselves: tests/test_torch_mamba.py).

The same parameters (the reference's init, carried over by
``interop.model_params_from_arrays``) and the same numpy tokens go through
both packages, activations in float32 on both sides. Tolerances:

  * ``decode_attention`` and the cached ``apply_attention``: 1e-5 x the
    reference's largest |value| (the einsums sum in another order);
  * prefill logits and caches (k/v, conv states, h), and every step of
    ``serve_step``: 1e-5 x scale (measured at most 4e-7 relative on the
    dense and MoE smoke configs, 8.8e-7 on the ssm and hybrid ones);
  * decode against the full forward: the reference tests' own bars,
    5e-3 x max(scale, 1) (MoE 2e-2, at capacity_factor 8 so that the full
    forward drops no token);
  * cache shapes, dtypes and partition specs: exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as RR
from repro.launch import sharding as RSh
from repro.models import layers as RL
from repro.models import model as RM

from repro_torch import interop, tree as TT
from repro_torch.configs import registry as TR
from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.launch import serve as TSv
from repro_torch.launch import sharding as TSh
from repro_torch.launch import steps as TSt
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

CPU = "cpu"
DECODE = [a for a in TR.list_archs()
          if TR.get_smoke_config(a).family in ("dense", "moe", "ssm",
                                               "hybrid")]
REL = 1e-5


@pytest.fixture
def f32_acts():
    old_r, old_t = RM.ACT_DTYPE, TM.ACT_DTYPE
    RM.ACT_DTYPE, TM.ACT_DTYPE = jnp.float32, torch.float32
    yield
    RM.ACT_DTYPE, TM.ACT_DTYPE = old_r, old_t


def _setup(arch, seed=1, **replace):
    rcfg = dataclasses.replace(RR.get_smoke_config(arch), **replace)
    cfg = dataclasses.replace(TR.get_smoke_config(arch), **replace)
    params, _ = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    pn = jax.tree.map(np.asarray, params)
    return rcfg, cfg, params, interop.model_params_from_arrays(cfg, pn,
                                                               device=CPU)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    live = want > -1e29          # padded vocab rows are -1e30 on both
    np.testing.assert_array_equal(got > -1e29, live, err_msg=what)
    scale = float(np.abs(want[live]).max()) if live.any() else 0.0
    gap = float(np.abs(got[live] - want[live]).max()) if live.any() else 0.0
    assert gap <= rel * max(scale, 1e-12), (what, gap, scale)


# ------------------------------------------------------- decode attention
@pytest.mark.parametrize("cur", [0, 5, 23])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_the_reference(cur, kv_dtype):
    B, S, H, K, hd = 2, 24, 4, 2, 16
    rng = np.random.default_rng(cur)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, hd)).astype(np.float32)
            for _ in range(2))
    jd, td = getattr(jnp, kv_dtype), getattr(torch, kv_dtype)
    # the bf16 cache: both sides start from the same bf16 values
    k16 = np.asarray(jnp.asarray(k).astype(jd).astype(jnp.float32))
    v16 = np.asarray(jnp.asarray(v).astype(jd).astype(jnp.float32))
    want = RL.decode_attention(jnp.asarray(q), jnp.asarray(k16).astype(jd),
                               jnp.asarray(v16).astype(jd), jnp.int32(cur))
    got = TL.decode_attention(torch.from_numpy(q),
                              torch.tensor(k16).to(td),
                              torch.tensor(v16).to(td), cur)
    assert got.dtype == torch.float32
    # bf16 rounding of p before p @ v may flip at a boundary: one bf16 ulp
    _close(got, want, REL if kv_dtype == "float32" else 8e-3)
    # keys past cur_index take no part: changing them changes nothing
    k2 = torch.tensor(k16).to(td)
    k2[:, cur + 1:] = 7.0
    np.testing.assert_array_equal(
        TL.decode_attention(torch.from_numpy(q), k2,
                            torch.tensor(v16).to(td), cur).numpy(),
        got.numpy())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b"])
def test_cached_attention_matches_the_reference_in_place(arch, f32_acts):
    rcfg, cfg, params, tree = _setup(arch)
    rp = jax.tree.map(lambda t: t[0], params["layers"]["attn"])
    tp = {n: t[0] for n, t in tree["layers"]["attn"].items()}
    B, T, idx = 2, 12, 7
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, T, cfg.num_kv_heads, cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    pos = np.full((B, 1), idx, np.int32)
    out_r, nc_r = RL.apply_attention(
        rp, jnp.asarray(x), rcfg, jnp.asarray(pos),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cache_index=jnp.int32(idx))
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(
        cv.copy())}
    out_t, nc_t = TL.apply_attention(tp, torch.from_numpy(x), cfg,
                                     torch.from_numpy(pos), cache=cache,
                                     cache_index=idx)
    _close(out_t, out_r)
    for name in ("k", "v"):
        assert nc_t[name] is cache[name]          # written in place
        _close(nc_t[name], nc_r[name], what=name)
        # only slot idx changed
        before = ck if name == "k" else cv
        np.testing.assert_array_equal(
            np.delete(nc_t[name].numpy(), idx, axis=1),
            np.delete(before, idx, axis=1))
    with pytest.raises(IndexError, match="out of range"):
        TL.apply_attention(tp, torch.from_numpy(x), cfg,
                           torch.from_numpy(pos), cache=cache,
                           cache_index=T)
    # a cached call decodes one token, and refuses more before any write
    held = {n: t.clone() for n, t in cache.items()}
    x2 = rng.standard_normal((B, 2, cfg.d_model)).astype(np.float32)
    with pytest.raises(ValueError, match="one token"):
        TL.apply_attention(tp, torch.from_numpy(x2), cfg,
                           torch.from_numpy(np.full((B, 2), 0, np.int32)),
                           cache=cache, cache_index=0)
    for name in ("k", "v"):
        assert torch.equal(cache[name], held[name])


# ------------------------------------------------------------ the caches
@pytest.mark.parametrize("arch", DECODE)
def test_make_and_grow_cache_match_the_reference(arch):
    rcfg, cfg = RR.get_smoke_config(arch), TR.get_smoke_config(arch)
    for kw, tkw in (({}, {}), ({"dtype": jnp.float32},
                               {"dtype": torch.float32})):
        rc = dict(TT.flatten(RM.make_cache(rcfg, 3, 10, **kw)))
        tc = TM.make_cache(cfg, 3, 10, device=CPU, **tkw)
        tcf = dict(TT.flatten(tc))
        assert set(rc) == set(tcf)
        for name in rc:
            assert tuple(tcf[name].shape) == rc[name].shape
            assert str(tcf[name].dtype).replace("torch.", "") == str(
                rc[name].dtype)
            assert not tcf[name].any()
        rg = dict(TT.flatten(RM.grow_cache(rcfg, RM.make_cache(
            rcfg, 3, 10, **kw), 5)))
        tg = TM.grow_cache(cfg, tc, 5)
        for name, t in TT.flatten(tg):
            assert tuple(t.shape) == rg[name].shape
            assert t.dtype == tcf[name].dtype
        assert TM.grow_cache(cfg, tc, 0) is tc
    meta = TSt.cache_abstract(cfg, SHAPES["decode_32k"])
    if cfg.family == "ssm":     # no time axis: the state is the same size
        assert meta["h"].is_meta and tuple(meta["h"].shape) == (
            cfg.num_layers, 128, cfg.d_inner, cfg.ssm_state)
    else:
        groups = (cfg.num_layers // cfg.attn_every
                  if cfg.family == "hybrid" else cfg.num_layers)
        assert meta["k"].is_meta and tuple(meta["k"].shape) == (
            groups, 128, 32_768, cfg.num_kv_heads, cfg.head_dim)


def test_grow_cache_pads_with_zeros_and_keeps_the_old_cache():
    cfg = TR.get_smoke_config("qwen2-1.5b")
    c = TM.make_cache(cfg, 2, 4, device=CPU)
    c["k"].fill_(1.0)
    g = TM.grow_cache(cfg, c, 3)
    assert g["k"].shape[2] == 7 and bool((g["k"][:, :, :4] == 1).all())
    assert not g["k"][:, :, 4:].any()
    g["k"][:, :, 0] = 2.0
    assert bool((c["k"] == 1).all())


# ------------------------------------------------- prefill and serve_step
@pytest.mark.parametrize("arch", DECODE)
def test_prefill_and_serve_steps_match_the_reference(arch, f32_acts):
    rcfg, cfg, params, tree = _setup(arch)
    B, P, G = 2, 16, 5
    toks = _tokens(cfg, (B, P))
    rlog, rc = jax.jit(lambda p, t: RM.prefill(p, rcfg, {"tokens": t}))(
        params, jnp.asarray(toks))
    tlog, tc = TM.prefill(tree, cfg, {"tokens": torch.from_numpy(toks)})
    _close(tlog, rlog, what="prefill logits")
    rflat = dict(TT.flatten(rc))
    assert set(rflat) == {p for p, _ in TT.flatten(tc)}
    for name, t in TT.flatten(tc):
        _close(t, rflat[name], what=f"prefill {name}")
    rc, tc = RM.grow_cache(rcfg, rc, G), TM.grow_cache(cfg, tc, G)
    step = jax.jit(lambda p, t, c, i: RM.serve_step(p, rcfg, t, c, i))
    nxt = _tokens(cfg, (G, B), seed=1)
    for t in range(G):
        rlog, rc = step(params, jnp.asarray(nxt[t]), rc, jnp.int32(P + t))
        tlog, tc = TM.serve_step(tree, cfg, torch.from_numpy(nxt[t]), tc,
                                 P + t)
        assert tlog.dtype == torch.float32
        _close(tlog, rlog, what=f"step {t} logits")
    rflat = dict(TT.flatten(rc))
    for name, t in TT.flatten(tc):
        _close(t, rflat[name], what=f"cache {name} after {G} steps")
    if "k" in tc:
        held = [t.clone() for t in TT.leaves(tc)]
        with pytest.raises(IndexError, match="out of range"):
            TM.serve_step(tree, cfg, torch.from_numpy(nxt[0]), tc, P + G)
        # raised before any layer wrote its state
        assert all(torch.equal(a, b) for a, b in zip(held, TT.leaves(tc)))
    else:
        # the ssm family has no time axis: no bound, and the position
        # changes nothing
        a, _ = TM.serve_step(tree, cfg, torch.from_numpy(nxt[0]),
                             TT.tree_map(torch.clone, tc), P + G)
        b, _ = TM.serve_step(tree, cfg, torch.from_numpy(nxt[0]),
                             TT.tree_map(torch.clone, tc), 524_287)
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", DECODE)
def test_smoke_decode_consistency(arch, f32_acts):
    """Sequential decode == full forward logits (f32), as the reference's
    test holds it; MoE at capacity_factor 8 (the full forward then drops
    no token, a one-token step never does)."""
    moe = TR.get_smoke_config(arch).family == "moe"
    rcfg, cfg, params, tree = _setup(
        arch, **({"capacity_factor": 8.0} if moe else {}))
    S = 16
    toks = _tokens(cfg, (2, S), seed=2)
    with torch.no_grad():
        full = TM.forward_logits(tree, cfg, {"tokens": torch.from_numpy(
            toks)}).numpy()
    cache = TM.make_cache(cfg, 2, S, dtype=torch.float32, device=CPU)
    V = cfg.vocab_size
    errs = []
    for t in range(S):
        logits, cache = TM.serve_step(tree, cfg, torch.from_numpy(
            toks[:, t]), cache, t)
        errs.append(float(np.abs(logits.numpy()[:, :V] - full[:, t, :V])
                          .max()))
    scale = float(np.abs(full[..., :V]).max())
    tol = 2e-2 if moe else 5e-3
    assert max(errs) <= tol * max(scale, 1.0), (max(errs), scale)
    # and the port's full forward is the reference's
    ref = np.asarray(RM.forward_logits(params, rcfg, {"tokens": jnp.asarray(
        toks)}))
    _close(full, ref, rel=1e-4)


@pytest.mark.parametrize("arch", DECODE)
def test_prefill_then_decode(arch, f32_acts):
    rcfg, cfg, params, tree = _setup(arch, seed=2)
    toks = _tokens(cfg, (2, 8), seed=3)
    logits, cache = TM.prefill(tree, cfg, {"tokens": torch.from_numpy(toks)})
    with torch.no_grad():
        fb = TM.forward_logits(tree, cfg, {"tokens": torch.from_numpy(toks)})
    V = cfg.vocab_size
    err = float((logits[:, :V] - fb[:, -1, :V]).abs().max())
    scale = float(fb[..., :V].abs().max())
    assert err <= 5e-3 * max(scale, 1.0)
    if cfg.family == "ssm":
        assert tuple(cache["h"].shape) == (cfg.num_layers, 2, cfg.d_inner,
                                           cfg.ssm_state)
    else:
        groups = (cfg.num_layers // cfg.attn_every
                  if cfg.family == "hybrid" else cfg.num_layers)
        assert tuple(cache["k"].shape) == (groups, 2, 8, cfg.num_kv_heads,
                                           cfg.head_dim)
    # the prefill cache feeds serve_step after grow_cache
    cache = TM.grow_cache(cfg, cache, 2)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    out, _ = TM.serve_step(tree, cfg, nxt, cache, 8)
    with torch.no_grad():
        fb2 = TM.forward_logits(tree, cfg, {"tokens": torch.cat(
            [torch.from_numpy(toks), nxt[:, None]], 1)})
    assert float((out[:, :V] - fb2[:, -1, :V]).abs().max()) <= (
        5e-3 * max(scale, 1.0))


# ------------------------------------------- step factories and pspecs
class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def test_cache_pspecs_follow_the_reference_rule():
    cfg = TR.get_smoke_config("qwen2-1.5b")
    rcfg = RR.get_smoke_config("qwen2-1.5b")
    shape = ShapeConfig("d", 64, 4, "decode")
    rmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    want = RSh.cache_shardings(jax.eval_shape(
        lambda: RM.make_cache(rcfg, 4, 64)), rcfg, rmesh)
    got = TSh.cache_pspecs(TSt.cache_abstract(cfg, shape), cfg,
                           Mesh((1, 1), ("data", "model"), device=CPU))
    assert {n: tuple(s.spec) for n, s in want.items()} == got
    assert got["k"] == (None, "data", "model")
    # larger meshes (described, not placed): batch on dim 1, the largest
    # divisible remaining dim on "model"
    cache = TSt.cache_abstract(cfg, shape)     # [2, 4, 64, 2, 16]
    assert TSh.cache_pspecs(cache, cfg, _FakeMesh(
        {"pod": 2, "data": 2, "model": 4}))["k"] == (
            None, ("pod", "data"), "model")
    assert TSh.cache_pspecs(cache, cfg, _FakeMesh(
        {"data": 8, "model": 128}))["v"] == ()


def test_prefill_and_serve_step_factories(f32_acts):
    rcfg, cfg, params, tree = _setup("granite-moe-1b-a400m")
    mesh = Mesh((1, 1), ("data", "model"), device=CPU)
    shape = ShapeConfig("d", 12, 2, "decode")
    pre, psp, csp = TSt.make_prefill_step(cfg, mesh, ShapeConfig(
        "p", 8, 2, "prefill"))
    assert psp["layers"]["moe"]["wi"] == (None, "model")
    # [L, B, 8, K, 16]: head_dim is the largest dim past the batch
    assert csp == {"k": (None, "data", None, None, "model"),
                   "v": (None, "data", None, None, "model")}
    assert TSt.make_prefill_step(cfg, mesh)[2] is None
    step, psp2, csp2 = TSt.make_serve_step(cfg, shape, mesh)
    assert psp2 == psp and csp2 == csp
    assert TSt.input_specs(cfg, shape)["tokens"].shape == (2,)
    toks = torch.from_numpy(_tokens(cfg, (2, 8)))
    logits, cache = pre(tree, {"tokens": toks})
    want, _ = TM.prefill(tree, cfg, {"tokens": toks})
    assert torch.equal(logits, want)
    cache = TM.grow_cache(cfg, cache, 4)
    held = cache["k"]
    out, cache = step(tree, toks[:, 0], cache, 8)
    assert cache["k"] is held and bool(held[:, :, 8].any())
    # qwen2-moe's full config places its params with FSDP (meta shapes
    # only here): data on the largest named dim left
    _, fpsp, _ = TSt.make_serve_step(TR.get_config("qwen2-moe-a2.7b"),
                                     shape, mesh)
    assert fpsp["layers"]["moe"]["wi"] == (None, "model", "data")
    vcfg = TR.get_smoke_config("internvl2-76b")
    vpre, _, vcsp = TSt.make_prefill_step(vcfg, mesh, ShapeConfig(
        "p", 16, 2, "prefill"))
    assert vcsp == {"k": (None, "data", None, None, "model"),
                    "v": (None, "data", None, None, "model")}
    vtree, _ = TM.init_model(vcfg, device=CPU)
    vbatch = {"tokens": torch.from_numpy(_tokens(vcfg, (2, 8))),
              "patches": torch.ones((2, 8, vcfg.d_model))}
    vlogits, vcache = vpre(vtree, vbatch)
    assert vcache["k"].shape == (2, 2, 16, 2, 16)
    assert torch.equal(vlogits, TM.prefill(vtree, vcfg, vbatch)[0])


# ------------------------------------------------------------ serve.main
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_serve_main_on_the_cpu(arch):
    B, P, G = 3, 16, 5
    events = []
    out = TSv.main(["--device", "cpu", "--smoke", "--arch", arch,
                    "--batch", str(B), "--prompt-len", str(P), "--gen",
                    str(G), "--seed", "4"],
                   callback=lambda ev, **kw: events.append(ev))
    assert events == ["prefilled", "decoded", "absorbed", "queried",
                      "clustered"]
    cfg = TR.get_smoke_config(arch)
    toks = out["tokens"]
    assert toks.shape == (B, G) and toks.min() >= 0
    assert toks.max() < cfg.vocab_size
    assert len(out["decode_ms"]) == G - 1 and out["prefill_ms"] > 0
    # every request fits in the sample: the estimates are exact
    stats = out["stats"]
    assert stats.shape == (3, 2)
    assert stats[0, 0] == B * (P + G) and stats[1, 0] == B
    assert stats[2, 0] == B
    assert out["centers"].shape == (2, 2) and np.isfinite(out["est_cost"])
    # the greedy tokens are the argmax of the decode the model gives
    tree, _ = TM.init_model(cfg, seed=4, device=CPU)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(4))
    logits, cache = TM.prefill(tree, cfg, {"tokens": prompts})
    assert np.array_equal(toks[:, 0], torch.argmax(logits, -1).numpy())
    cache = TM.grow_cache(cfg, cache, G)
    for t in range(1, G):
        logits, cache = TM.serve_step(tree, cfg, torch.from_numpy(
            toks[:, t - 1]), cache, P + t - 1)
        assert np.array_equal(toks[:, t], torch.argmax(logits, -1).numpy())


def test_serve_main_prefill_only_and_unserved_families():
    out = TSv.main(["--device", "cpu", "--smoke", "--batch", "1", "--gen",
                    "1"])
    assert out["tokens"].shape == (1, 1) and out["decode_ms"] == []
    with pytest.raises(SystemExit, match="encoder-only"):
        TSv.main(["--device", "cpu", "--smoke", "--arch", "hubert-xlarge"])
    out = TSv.main(["--device", "cpu", "--smoke", "--arch", "internvl2-76b",
                    "--batch", "1", "--prompt-len", "8", "--gen", "3"])
    assert out["tokens"].shape == (1, 3) and len(out["decode_ms"]) == 2
    with pytest.raises(SystemExit):
        TSv.main(["--device", "cpu", "--smoke", "--gen", "0"])
