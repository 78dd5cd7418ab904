"""Parity of the port's MoE family with the JAX package, on the CPU:
``moe_capacity``, ``init_moe`` and the MoE tree through ``interop``,
``apply_moe`` (output, aux losses, routing), the MoE ``loss_fn`` and its
gradients against ``jax.grad``, three train steps against a single-device
JAX loop, the exchange's sampler, the partition rules and AdamW's decay on
the 4-d expert leaves, and ``train.main --compress`` on granite-moe.

The same parameters (the reference's init, carried over by
``interop.model_params_from_arrays``) and the same numpy inputs go through
both packages, activations in float32 unless a test says bf16.
Tolerances:

  * ``apply_moe`` output and aux losses: 1e-5 x scale in float32 (sums in
    another order), 2e-2 x scale in bf16 (one bf16 rounding of each
    product, taken in another order);
  * routing on an exactly representable router (integer inputs and router
    weights, or a zero router: the logits are exact integers on both
    sides, tied logits give bit-equal gates): top-k indices, slots, keep
    and destinations EXACT, ties and drops included, and the renormalised
    gates within 1e-6;
  * the exchange's slab of an expert leaf: as the dense leaves'
    (tests/torch_parity.py: keys, valid, member, weights exact, probs
    and seeds within their ulp bounds);
  * loss rtol 1e-6, gradients 1e-5 x max |g| per leaf (as the dense
    family's test), three AdamW steps: losses rtol 1e-5, params rtol 1e-4
    / atol 1e-4 (see the test).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as RR
from repro.distopt import compression as RC
from repro.launch import sharding as RSh
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.optim import adamw as RA

from repro_torch import interop, tree as TT
from repro_torch.configs import registry as TR
from repro_torch.distopt import compression as TC
from repro_torch.kernels import moe_slots as KS
from repro_torch.launch import mesh as TMe
from repro_torch.launch import sharding as TSh
from repro_torch.launch import steps as TSt
from repro_torch.launch import train as TTr
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.optim import adamw as TA
from tests.torch_parity import PROB_ULP, SEED_ULP, assert_ulp, to_np

CPU = "cpu"
MOE = [a for a in TR.list_archs() if TR.get_smoke_config(a).family == "moe"]


@pytest.fixture
def f32_acts():
    old_r, old_t = RM.ACT_DTYPE, TM.ACT_DTYPE
    RM.ACT_DTYPE, TM.ACT_DTYPE = jnp.float32, torch.float32
    yield
    RM.ACT_DTYPE, TM.ACT_DTYPE = old_r, old_t


def _moe_params(arch, seed=0, **replace):
    """(ref cfg, port cfg, one layer's reference moe params as numpy)."""
    rcfg = dataclasses.replace(RR.get_smoke_config(arch), **replace)
    cfg = dataclasses.replace(TR.get_smoke_config(arch), **replace)
    p, _ = RMOE.init_moe(jax.random.PRNGKey(seed), rcfg)
    return rcfg, cfg, jax.tree.map(np.asarray, p)


def _t(tree, dtype=torch.float32):
    return TT.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                       tree)


def _gap_ok(got, want, rel):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    gap = float(np.abs(got - want).max())
    assert gap <= rel * max(scale, 1e-12), (gap, scale)


def _ref_routing(p, x, rcfg):
    """The reference's routing, step for step as ``repro.models.moe.
    apply_moe`` computes it: (topv, topi, slot, keep, dest)."""
    B, S, _ = x.shape
    E, k = RMOE._n_experts(rcfg), rcfg.moe_top_k
    C = RMOE.moe_capacity(S, rcfg)
    logits = (x @ p["router"].astype(x.dtype)).astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    topv, topi = jax.lax.top_k(gates, k)
    topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    slot, keep, dest = _ref_slots(topi.reshape(B, S * k), E, C)
    return (np.asarray(topv), np.asarray(topi), slot, keep, dest)


def _ref_slots(flat_e, E, C):
    """The reference's slot assignment (``repro.models.moe.apply_moe``)
    of flat_e [B, n]: (slot, keep, dest) as numpy."""
    flat_e = jnp.asarray(flat_e)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, E, dtype=jnp.int32), axis=1) - 1
    slot = jnp.take_along_axis(pos, flat_e[..., None], axis=-1)[..., 0]
    keep = slot < C
    dest = jnp.where(keep, flat_e * C + slot, E * C)
    return tuple(np.asarray(a) for a in (slot, keep, dest))


# --------------------------------------------------------- init and sizes
@pytest.mark.parametrize("arch", MOE)
def test_moe_capacity_and_expert_count_match(arch):
    for get in ("get_config", "get_smoke_config"):
        rcfg, cfg = getattr(RR, get)(arch), getattr(TR, get)(arch)
        for cf in (0.5, 1.25, 8.0):
            r = dataclasses.replace(rcfg, capacity_factor=cf)
            t = dataclasses.replace(cfg, capacity_factor=cf)
            for s in (1, 7, 16, 128, 1024):
                assert TMOE.moe_capacity(s, t) == RMOE.moe_capacity(s, r)
        padded = dataclasses.replace(cfg, num_experts_padded=64)
        assert TMOE._n_experts(padded) == RMOE._n_experts(
            dataclasses.replace(rcfg, num_experts_padded=64)) == 64
        assert TMOE._n_experts(cfg) == cfg.num_experts


@pytest.mark.parametrize("arch", MOE)
def test_init_tree_specs_and_interop_match_the_reference(arch):
    rcfg, cfg = RR.get_smoke_config(arch), TR.get_smoke_config(arch)
    rparams, rspecs = RM.init_model(jax.random.PRNGKey(0), rcfg)
    rparams = jax.tree.map(np.asarray, rparams)
    tparams, tspecs = TM.init_model(cfg, seed=0, device=CPU)
    rflat, tflat = TT.flatten(rparams), TT.flatten(tparams)
    assert [p for p, _ in rflat] == [p for p, _ in tflat]
    for (path, r), (_, t) in zip(rflat, tflat):
        assert r.shape == tuple(t.shape) and t.dtype == torch.float32, path
    rs = dict(TT.flatten(jax.tree.map(
        lambda s: s, rspecs, is_leaf=lambda s: isinstance(s, tuple))))
    assert rs == dict(TT.flatten(tspecs))
    assert ("layers.moe.shared.wi" in rs) == bool(cfg.num_shared_experts)
    wi = tparams["layers"]["moe"]["wi"]
    assert float(wi.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-6
    # the reference's tree carried over and back exactly
    tree = interop.model_params_from_arrays(cfg, rparams, device=CPU)
    back = interop.model_params_to_arrays(TM.Model(cfg, tree).tree())
    for (p, a), (q, b) in zip(rflat, TT.flatten(back)):
        assert p == q
        np.testing.assert_array_equal(a, b)
    # full-width trees: the real parameter counts
    meta, _ = TM.abstract_params(TR.get_config(arch))
    n = sum(x.numel() for x in TT.leaves(meta))
    assert n == {"granite-moe-1b-a400m": 1_334_756_352,
                 "qwen2-moe-a2.7b": 14_315_735_040}[arch]


# ----------------------------------------------------------- apply_moe
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_apply_moe_matches_the_reference(arch, cf):
    rcfg, cfg, p = _moe_params(arch, capacity_factor=cf)
    x = np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    rout, raux = RMOE.apply_moe(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), rcfg)
    tout, taux = TMOE.apply_moe(_t(p), torch.from_numpy(x), cfg)
    _gap_ok(tout, rout, 1e-5)
    for name in ("moe_aux", "moe_z"):
        assert float(taux[name]) == pytest.approx(float(raux[name]),
                                                  rel=1e-6)


@pytest.mark.parametrize("router", ["zero", "integer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_routing_is_exact_on_an_exact_router(arch, dtype, router):
    """Integer activations and router weights make every logit an exact
    integer on both sides (ties are the rule: the zero router ties every
    expert), so top-k, slots, drops and destinations must be equal."""
    rcfg, cfg, p = _moe_params(arch, capacity_factor=0.5)
    rng = np.random.default_rng(2)
    B, S, D = 2, 32, cfg.d_model
    x = rng.integers(-1, 2, (B, S, D)).astype(np.float32)
    p["router"] = (np.zeros_like(p["router"]) if router == "zero" else
                   rng.integers(-1, 2, p["router"].shape).astype(np.float32))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rx = jnp.asarray(x).astype(jd)
    tx = torch.from_numpy(x).to(td)
    topv, topi, slot, keep, dest = _ref_routing(
        jax.tree.map(jnp.asarray, p), rx, rcfg)
    r = TMOE.route(_t(p), tx, cfg)
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.dest.numpy(), dest)
    np.testing.assert_allclose(r.topv.numpy(), topv, rtol=1e-6, atol=0)
    assert 0 < int(keep.sum()) < keep.size          # drops happen
    if router == "zero":                            # ties: lowest index
        assert (topi == np.arange(rcfg.moe_top_k)).all()
    rout, raux = RMOE.apply_moe(jax.tree.map(jnp.asarray, p), rx, rcfg)
    tout, taux = TMOE.apply_moe(_t(p), tx, cfg)
    assert tout.dtype == td
    _gap_ok(tout, rout, 1e-5 if dtype == "float32" else 2e-2)
    for name in ("moe_aux", "moe_z"):
        assert float(taux[name]) == pytest.approx(float(raux[name]),
                                                  rel=1e-6)


def test_padded_experts_take_no_tokens():
    rcfg, cfg, p = _moe_params("granite-moe-1b-a400m",
                               num_experts_padded=8)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    r = TMOE.route(_t(p), torch.from_numpy(x), cfg)
    assert int(r.topi.max()) < cfg.num_experts
    rout, _ = RMOE.apply_moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             rcfg)
    tout, _ = TMOE.apply_moe(_t(p), torch.from_numpy(x), cfg)
    _gap_ok(tout, rout, 1e-5)


# ------------------------------------------------ the slot count (K8)
def _slot_input(kind, rng, B=3, n=1000):
    """(flat_e [B, n] int64, E, C): "ties", 2 experts (every choice ties
    with half the row); "overflow", every choice to expert 3 of 8; "padded",
    the first 60 of 64 experts; "routed", 8 distinct experts of 32 a token;
    each with a capacity that drops many choices."""
    if kind == "ties":
        return rng.integers(0, 2, (B, n)), 2, 200
    if kind == "overflow":
        return np.full((B, n), 3), 8, 40
    if kind == "padded":
        return rng.integers(0, 60, (B, n)), 64, 16
    tok = np.argsort(rng.random((B, n // 8, 32)), axis=-1)[..., :8]
    return tok.reshape(B, -1), 32, 24


SLOT_KINDS = ["ties", "overflow", "padded", "routed"]


@pytest.mark.parametrize("kind", SLOT_KINDS)
def test_expert_slots_plain_matches_the_reference(kind):
    flat_e, E, C = _slot_input(kind, np.random.default_rng(4))
    got = KS.expert_slots_plain(torch.from_numpy(flat_e), E, C)
    want = _ref_slots(flat_e, E, C)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), w)
    assert got[0].dtype == got[2].dtype == torch.int64
    assert got[1].dtype == torch.bool
    assert 0 < int(got[1].sum()) < got[1].numel()      # drops happen


def _no_library():
    raise AssertionError("the kernel library was asked for off the card")


def test_expert_slots_on_meta_gives_shapes_without_a_launch(monkeypatch):
    monkeypatch.setattr(KS, "kernel_lib", _no_library)
    monkeypatch.setattr(KS.expert_slots, "launches", 0)
    flat_e = torch.empty((4, 32_768), dtype=torch.int64, device="meta")
    slot, keep, dest = KS.expert_slots(flat_e, 32, 1280)
    for t, dt in ((slot, torch.int64), (keep, torch.bool),
                  (dest, torch.int64)):
        assert t.device.type == "meta" and t.dtype == dt
        assert t.shape == (4, 32_768)
    assert KS.expert_slots.launches == 0


@pytest.mark.parametrize("kind", SLOT_KINDS)
def test_expert_slots_on_the_cpu_takes_the_plain_version(monkeypatch,
                                                         kind):
    monkeypatch.setattr(KS, "kernel_lib", _no_library)
    monkeypatch.setattr(KS.expert_slots, "launches", 0)
    flat_e, E, C = _slot_input(kind, np.random.default_rng(5))
    flat_e = torch.from_numpy(flat_e)
    for a, w in zip(KS.expert_slots(flat_e, E, C),
                    KS.expert_slots_plain(flat_e, E, C)):
        assert torch.equal(a, w)
    assert KS.expert_slots.launches == 0


def test_route_on_the_cpu_launches_no_slot_kernel(monkeypatch):
    monkeypatch.setattr(KS, "kernel_lib", _no_library)
    monkeypatch.setattr(KS.expert_slots, "launches", 0)
    _, cfg, p = _moe_params("granite-moe-1b-a400m")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    r = TMOE.route(_t(p), x, cfg)
    C = TMOE.moe_capacity(16, cfg)
    for a, w in zip((r.slot, r.keep, r.dest), KS.expert_slots_plain(
            r.topi.reshape(2, -1), cfg.num_experts, C)):
        assert torch.equal(a, w)
    assert KS.expert_slots.launches == 0


def test_slot_kernel_refuses_what_it_cannot_take():
    flat_e = torch.zeros((2, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="experts"):
        KS.expert_slots_kernel(flat_e, KS.MAX_EXPERTS + 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        KS.expert_slots_kernel(flat_e, 32, 8)
    with pytest.raises(ValueError, match=r"\[B, n\]"):
        KS.expert_slots_kernel(flat_e[0], 32, 8)


@pytest.mark.parametrize("n", [1, 8, 256, 257, 8008, 32_768, 262_144,
                               262_145, 1 << 20])
def test_slot_tile_is_what_the_kernel_takes(n):
    """A power of two from 256 (one block's 8 warps of 32) to 8,192 (32
    choices a lane), and at most 32 tiles a row below that."""
    tile = KS.slot_tile(n)
    assert tile & (tile - 1) == 0 and 256 <= tile <= KS.MAX_TILE
    assert -(-n // tile) <= KS.TILES_PER_ROW or tile == KS.MAX_TILE
    assert tile == 256 or -(-n // (tile // 2)) > KS.TILES_PER_ROW


def _kernel_layout_slots(flat_e, E, C):
    """The slots as ``csrc/moe_slots.cu`` forms them, stated in numpy: per
    tile of ``slot_tile(n)`` choices the row's earlier tiles' counts, per
    warp of the block's 8 (TILE / 8 consecutive choices) the block's
    earlier warps' counts, then the warp's running count and the lanes
    below in each group of 32."""
    B, n = flat_e.shape
    tile = KS.slot_tile(n)
    tiles, per_warp = -(-n // tile), tile // 8
    pad = np.full((B, tiles * tile), -1)
    pad[:, :n] = flat_e
    g = pad.reshape(B, tiles, 8, per_warp // 32, 32)
    onehot = (g[..., None] == np.arange(E)).astype(np.int64)
    lanes = np.cumsum(onehot, axis=4) - onehot          # lanes below
    chunk = onehot.sum(4, keepdims=True)
    running = np.cumsum(chunk, axis=3) - chunk           # warp's earlier
    warp = onehot.sum((3, 4), keepdims=True)
    warps = np.cumsum(warp, axis=2) - warp               # block's earlier
    tiles_ = warp.sum(2, keepdims=True)
    earlier = np.cumsum(tiles_, axis=1) - tiles_         # row's earlier
    ranks = lanes + running + warps + earlier
    slot = np.take_along_axis(ranks, np.maximum(g, 0)[..., None],
                              axis=-1)[..., 0].reshape(B, -1)[:, :n]
    keep = slot < C
    return slot, keep, np.where(keep, flat_e * C + slot, E * C)


@pytest.mark.parametrize("n", [8, 300, 2048, 8008, 20_000])
def test_kernel_layout_gives_the_plain_slots(n):
    rng = np.random.default_rng(n)
    flat_e = rng.integers(0, 6, (2, n))
    got = _kernel_layout_slots(flat_e, 6, n // 8)
    want = KS.expert_slots_plain(torch.from_numpy(flat_e), 6, n // 8)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w.numpy())


# ----------------------------------------------------- loss and gradients
@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_grads_match_the_reference(arch, f32_acts):
    rcfg, cfg = RR.get_smoke_config(arch), TR.get_smoke_config(arch)
    rparams, _ = RM.init_model(jax.random.PRNGKey(0), rcfg)
    params_np = jax.tree.map(np.asarray, rparams)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    (rl, rm), rg = jax.value_and_grad(
        lambda p: RM.loss_fn(p, rcfg, batch), has_aux=True)(rparams)
    rg = dict(TT.flatten(jax.tree.map(np.asarray, rg)))
    tree = interop.model_params_from_arrays(cfg, params_np, device=CPU)
    model = TM.Model(cfg, tree)
    tl, tm = model({"tokens": torch.from_numpy(toks)})
    named = list(model.named_parameters())
    tg = {n: g.numpy() for (n, _), g in zip(
        named, torch.autograd.grad(tl, [q for _, q in named]))}
    assert abs(float(tl.detach()) - float(rl)) <= 1e-6 * abs(float(rl))
    for name in ("ce", "moe_aux", "moe_z"):
        assert float(tm[name].detach()) == pytest.approx(float(rm[name]),
                                                         rel=1e-6)
    assert float(tm["moe_aux"].detach()) > 0
    assert float(tm["moe_z"].detach()) > 0
    assert set(rg) == set(tg)
    for path in rg:
        scale = float(np.abs(rg[path]).max())
        gap = float(np.abs(rg[path] - tg[path]).max())
        assert gap <= 1e-5 * max(scale, 1e-12), (path, gap, scale)


def test_three_moe_steps_match_a_single_device_jax_loop(f32_acts):
    """granite-moe smoke: loss_fn, jax.grad and apply_updates on one
    device against make_train_step with the sampled exchange at one pod
    (every leaf of >= 1024 elements sampled, and returned as it came)."""
    arch = "granite-moe-1b-a400m"
    rcfg, cfg = RR.get_smoke_config(arch), TR.get_smoke_config(arch)
    rparams, _ = RM.init_model(jax.random.PRNGKey(0), rcfg)
    params_np = jax.tree.map(np.asarray, rparams)
    ropt = RA.OptConfig(total_steps=60, warmup_steps=3, peak_lr=5e-3)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
               for _ in range(3)]
    rstate = {"params": rparams, "opt": RA.init_opt_state(rparams)}
    rlosses = []
    for toks in batches:
        (loss, _), grads = jax.value_and_grad(
            lambda p: RM.loss_fn(p, rcfg, {"tokens": jnp.asarray(toks)}),
            has_aux=True)(rstate["params"])
        new_p, new_opt, _ = RA.apply_updates(rstate["params"], grads,
                                             rstate["opt"], ropt)
        rstate = {"params": new_p, "opt": new_opt}
        rlosses.append(float(loss))
    mesh = TMe.Mesh((1, 1, 1), ("pod", "data", "model"), device=CPU)
    step, specs = TSt.make_train_step(cfg, TA.OptConfig(**ropt.__dict__),
                                      mesh, compress=dict(k=256,
                                                          min_size=1024))
    assert specs["params"]["layers"]["moe"]["wg"] == (None, "model")
    tparams = interop.model_params_from_arrays(cfg, params_np, device=CPU)
    state = {"params": tparams, "opt": TA.init_opt_state(tparams)}
    tlosses = []
    for toks in batches:
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        tlosses.append(float(m["loss"]))
    np.testing.assert_allclose(tlosses, rlosses, rtol=1e-5)
    # atol 1e-4 is 2 % of one Adam step at the peak lr: an entry whose
    # gradient is rounding noise on both sides gets a noise-driven Adam
    # direction (2 of wq's 8192 entries moved 2.8e-5 apart); a missed or
    # flipped update would be a whole step off
    for (p, a), (_, b) in zip(TT.flatten(jax.tree.map(
            np.asarray, rstate["params"])), TT.flatten(state["params"])):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-4,
                                   err_msg=p)


# ------------------------------------- partition rules and AdamW decay
@pytest.mark.parametrize("arch", MOE)
def test_expert_leaves_partition_and_decay_as_the_reference(arch):
    cfg = TR.get_config(arch)
    meta, specs = TM.abstract_params(cfg)

    class _M:
        def __init__(self, shape):
            self.shape = shape
            self.axis_names = tuple(shape)
    for msize in (1, 4, 8):
        mesh = _M({"data": 2, "model": msize})
        psp = TSh.param_pspecs(specs, meta, mesh)
        for path, spec in TT.flatten(psp):
            leaf = dict(TT.flatten(meta))[path]
            want = RSh.logical_to_pspec(
                tuple(dict(TT.flatten(specs))[path]), tuple(leaf.shape),
                _M({"data": 2, "model": msize}))
            assert spec == tuple(want), (path, msize)
        moe = psp["layers"]["moe"]
        if cfg.num_experts % msize == 0:       # else "mlp" takes "model"
            assert moe["wi"] == moe["wg"] == moe["wo"] == (None, "model")
    # AdamW decays exactly the ndim >= 2 leaves: the 4-d experts included
    rcfg = RR.get_smoke_config(arch)
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
    assert params["layers"]["moe"]["wi"].ndim == 4
    assert rcfg.num_experts == tcfg.num_experts


# ----------------------------------------------------------- train.main
def test_train_main_trains_granite_moe_with_the_exchange():
    losses = {}
    state = TTr.main(
        ["--device", "cpu", "--smoke", "--arch", "granite-moe-1b-a400m",
         "--steps", "3", "--batch", "4", "--seq", "32", "--mesh", "1x1x1",
         "--compress", "--importance-sampling", "--log-every", "1"],
        callback=lambda ev, **kw: ev == "step" and losses.__setitem__(
            kw["step"], float(kw["metrics"]["loss"])))
    assert sorted(losses) == [1, 2, 3]
    assert all(np.isfinite(v) and v > 0 for v in losses.values())
    assert int(state["opt"]["step"]) == 3
    assert int(state["tel"].valid.sum()) == 12
    # qwen2-moe's full config places its params and moments with FSDP
    _, specs = TSt.make_train_step(
        TR.get_config("qwen2-moe-a2.7b"), TA.OptConfig(),
        TMe.Mesh((1, 1), ("data", "model"), device=CPU))
    assert specs["opt"]["m"]["layers"]["moe"]["wi"] == (None, "model",
                                                         "data")


@pytest.mark.parametrize("leaf", ["wi", "router"])
def test_exchange_samples_an_expert_leaf_as_the_reference(leaf, f32_acts):
    """The sampled exchange's slab of a real MoE gradient leaf (the 4-d
    [L, E, D, F] expert weights, the 3-d router): keys are positions in
    the flattened stacked leaf, as the reference's."""
    arch = "granite-moe-1b-a400m"
    rcfg = RR.get_smoke_config(arch)
    rparams, _ = RM.init_model(jax.random.PRNGKey(0), rcfg)
    toks = np.random.default_rng(0).integers(
        0, rcfg.vocab_size, (2, 32)).astype(np.int32)
    grads = jax.grad(lambda p: RM.loss_fn(
        p, rcfg, {"tokens": jnp.asarray(toks)})[0])(rparams)
    g = np.array(grads["layers"]["moe"][leaf])
    ref = RC._sample_leaf(jnp.asarray(g), 256, jnp.uint32(77), 0.01)
    got = TC._sample_leaf(torch.from_numpy(g), 256, 77, 0.01)
    for name in ("keys", "valid", "member", "aux", "weights"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      to_np(getattr(got, name)), err_msg=name)
    assert_ulp(ref.probs, got.probs, PROB_ULP, "probs")
    assert_ulp(ref.seeds, got.seeds, SEED_ULP, "seeds")
    assert 0 < int(got.valid.sum()) <= 768
    assert int(got.keys.max()) < g.size
