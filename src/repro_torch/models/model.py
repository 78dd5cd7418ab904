"""Model assembly for all six families.

Port of ``repro/models/model.py``: dense, MoE, ``ssm`` (Mamba-1),
``hybrid`` (Mamba-2 with shared attention blocks), ``encoder``
(bidirectional, over stub frame embeddings) and ``vlm`` (a decoder over
``[patches | text]``, the patches a stub frontend's embeddings):
  init_model(cfg, seed, device) -> (params, specs)  (specs: logical axes)
  loss_fn(params, cfg, batch)    -> (loss, metrics)  (training forward)
  forward_logits(params, cfg, batch) -> [B, S, V]   (small models / tests)
  prefill(params, cfg, batch)    -> (last-position logits, decode cache);
      an encoder's is its inference forward, with the cache {}
  serve_step(params, cfg, tokens, cache, index) -> (logits [B, V], cache)
  make_cache / grow_cache; Model(cfg, params): the tree as nn.Parameters

The stack is described once: ``_plan(cfg)`` gives its stages in order,
each a run of stacked layers of one kind (attention + MLP or MoE; Mamba;
the JAX package's hybrid groups: ``attn_every`` Mamba-2 layers, then ONE
attention + MLP block that every group shares, on the residual stream)
or a call of a shared block of the published Zamba2 block (below).
``_walk`` runs a plan in all three modes: training (each run a
``cost.scan``, each layer or group recomputed in backward under
``cfg.remat``; each call a checkpoint of its own), and a prefill or a
decode step (each run a ``cost.loop``; the prefill keeps each layer's SSM
state and k/v, the decode step writes them into the cache it is given,
which it returns). The k/v cache has a slot per attention layer, group
or call.

The published Zamba2 block (``cfg.hybrid_ids``): with e the embedded
tokens and h the residual stream, Mamba layer i computes h <- h +
Mamba2(RMSNorm(h + t_i)), where t_i is 0 but before the j-th of
``hybrid_ids``, where the shared block B_(j mod ``shared_blocks``) runs on
u = RMSNorm_2d([h, e]): attention (q, k, v from u, 2d wide; RoPE; the
softmax scale ``attn_scale``) projected to d, RMSNorm_d, then the gated
MLP gelu(a) b whose [a, b] adds the call's own LoRA adapter (x A_j) B_j,
with no residual inside the block; then t_i = its output times the
call's own d x d projection. ``shared`` stacks the blocks' leaves
[n_blocks, ...]; ``adapter`` and ``proj`` stack the calls'. It has no
tensor-parallel form: a ``model`` axis over 1 raises.

The parameter tree is the reference's: stacked ``[L, ...]`` layer leaves,
``(d_in, d_out)`` weights, the same names (the gradient exchange keys a
leaf's coordinates by their place in the stacked leaf and AdamW decays
the leaves with ``ndim >= 2``: per-layer modules would change both).
Initialisation draws from a ``torch.Generator`` (parity with the
reference goes through ``interop.model_params_from_arrays``).
``ACT_DTYPE`` is read at call time (tests set float32). A vlm's cache
holds the patches first: its text decodes from ``frontend_tokens +
prompt length``. An encoder keeps ``emb.tok``, with a zero gradient.

Placed params (``sh``, a ``parallel.Shards``: this rank's blocks and their
pspecs): each layer gathers its ``data``-placed (FSDP) leaves inside its
(checkpointed) function, and at a ``model`` axis over 1 the attention,
MLP, MoE, Mamba blocks, embedding and loss run as sums of the ranks'
parts (``models/parallel.py``). The decode cache is then this rank's
block too (``cache_dim``, ``state_dims``: the per-layer dims of k/v and of
the Mamba states on ``model``, as ``sharding.cache_pspecs`` places them).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.launch import cost
from repro_torch.telemetry import spans
from . import layers as L
from . import mamba as M
from . import moe as MOE
from . import parallel as P
from .config import ModelConfig

ACT_DTYPE = torch.bfloat16

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")

# the published block's per-call leaves
_CALL_LEAVES = ("adapter", "proj")


def check_family(cfg: ModelConfig):
    """Raise for a family name the model code does not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         f"known: {FAMILIES}")


def _decodes(cfg: ModelConfig) -> bool:
    """False for an encoder, which has no decode step."""
    return cfg.family != "encoder"


def _check_decodes(cfg: ModelConfig):
    if not _decodes(cfg):
        raise ValueError(f"{cfg.name}: an encoder has no decode step")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(init, cfg, lead=()):
    """An attention + MLP block: (params, specs)."""
    p, s = {}, {}
    p["ln1"], s["ln1"] = L.init_norm(init, cfg.norm_kind, cfg.attn_in, lead)
    p["attn"], s["attn"] = L.init_attention(init, cfg, lead)
    p["ln2"], s["ln2"] = L.init_norm(init, cfg.norm_kind, cfg.d_model, lead)
    if cfg.family == "moe":
        p["moe"], s["moe"] = MOE.init_moe(init, cfg, lead)
    else:
        p["mlp"], s["mlp"] = L.init_mlp(init, cfg, lead=lead)
    return p, s


def init_model(cfg: ModelConfig, seed: int = 0, device=None):
    """(params, specs) of a model, drawn from ``seed`` on ``device``
    (default: the card; ``"meta"`` gives shapes only)."""
    check_family(cfg)
    init = L.Init(resolve_device(device), seed)
    lead = (cfg.num_layers,)
    p, s = {}, {}
    p["emb"], s["emb"] = L.init_embedding(init, cfg)
    if cfg.family in ("ssm", "hybrid"):
        init_ssm = M.init_mamba1 if cfg.family == "ssm" else M.init_mamba2
        lp, ls = {}, {}
        lp["ln1"], ls["ln1"] = L.init_norm(init, cfg.norm_kind, cfg.d_model,
                                           lead)
        lp["mamba"], ls["mamba"] = init_ssm(init, cfg, lead)
    else:
        lp, ls = _init_block(init, cfg, lead)
    p["layers"] = lp
    # the stacked (looped, unsharded) layer axis leads every layer spec
    s["layers"] = T.tree_map(lambda sp: (None,) + tuple(sp), ls)
    p["ln_f"], s["ln_f"] = L.init_norm(init, cfg.norm_kind, cfg.d_model)
    if cfg.published_hybrid:
        # the shared blocks, then each call's adapter and projection,
        # stacked (a looped, unsharded leading axis)
        n = len(cfg.hybrid_ids)
        stack = lambda sp: T.tree_map(lambda t: (None,) + tuple(t), sp)
        p["shared"], ss = _init_block(init, cfg, (cfg.shared_blocks,))
        p["adapter"], sa = L.init_adapter(init, cfg, (n,))
        p["proj"], sp = {}, {}
        p["proj"]["w"], sp["w"] = L.dense_init(
            init, cfg.d_model, cfg.d_model, ("embed", None), (n,))
        s["shared"], s["adapter"], s["proj"] = stack(ss), stack(sa), stack(sp)
    elif cfg.family == "hybrid":
        # ONE attention + MLP block shared by every group, unstacked
        p["shared"], s["shared"] = _init_block(init, cfg)
    return p, s


def abstract_params(cfg: ModelConfig):
    """(meta-device parameter tree, spec tree): shapes without drawing or
    allocating anything."""
    return init_model(cfg, device="meta")


# ---------------------------------------------------------------------------
# the blocks: each takes its state and gives its new state in all modes
# ---------------------------------------------------------------------------

def _tp(sh):
    """``sh`` when it asks for tensor parallelism, else None."""
    return sh if sh is not None and sh.tp else None


def _whole(lp, sh):
    """A layer's leaves with their FSDP (``data``) blocks gathered."""
    return lp if sh is None else sh.whole_over_data(lp)


def _ffn(lp, h, cfg, sh=None):
    """The layer's MLP or MoE block: (out, aux losses)."""
    if "moe" in lp:
        return MOE.apply_moe(lp["moe"], h, cfg,
                             None if sh is None else sh["moe"])
    if _tp(sh):
        return P.mlp(sh["mlp"], lp["mlp"], h, cfg), {}
    return L.apply_mlp(lp["mlp"], h, cfg), {}


def _attend(lp, h, cfg, positions, sh, kv, index, keep, cache_dim):
    """The attention block over h: (out, the whole sequence's (k, v) when
    ``keep``, else None); a decode step against ``kv``, written in place."""
    if kv is not None:
        if _tp(sh):
            return P.decode_attention(sh["attn"], lp["attn"], h, cfg,
                                      positions, kv["k"], kv["v"], index,
                                      cache_dim), None
        return L.apply_attention(lp["attn"], h, cfg, positions, cache=kv,
                                 cache_index=index)[0], None
    if _tp(sh):
        return P.attention(sh["attn"], lp["attn"], h, cfg, positions,
                           causal=cfg.causal if keep else None)
    a, new = L.apply_attention(lp["attn"], h, cfg, positions)
    return a, (new["k"], new["v"]) if keep else None


def _transformer_layer(lp, x, cfg, positions, sh=None, kv=None, index=None,
                       keep=False, cache_dim=None):
    """An attention + MLP (or MoE) layer: (x, aux losses, k/v). Over the
    whole sequence (``keep``: a prefill's, whose k and v it gives for the
    cache, placed cut to this rank's block on per-layer dim ``cache_dim``),
    or a decode step at ``index`` against ``kv``, its cache slot."""
    lp = _whole(lp, sh)
    h = L.apply_norm(lp["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    a, new = _attend(lp, h, cfg, positions, sh, kv, index, keep, cache_dim)
    x = x + a
    if kv is None and not keep:   # training frees it before the MLP
        del a
    if new is not None and _tp(sh) and cache_dim is not None:
        new = [P.block(t, cache_dim, sh) for t in new]
    h = L.apply_norm(lp["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    m, aux = _ffn(lp, h, cfg, sh)
    x = x + m
    return x, aux, new and {n: t.to(ACT_DTYPE) for n, t in zip("kv", new)}


def _mixer(h, p, cfg, state, return_state, sh, dims):
    """A Mamba block over h: (y, its new state)."""
    if _tp(sh):
        return P.mamba(sh["mamba"], p, h, cfg, state, return_state, dims)
    apply = M.apply_mamba1 if cfg.ssm_kind == "mamba1" else M.apply_mamba2
    return apply(p, h, cfg, state=state, return_state=return_state)


def _ssm_layer(lp, x, cfg, state=None, return_state=False, sh=None,
               dims=None, t=None):
    """Pre-norm residual Mamba layer: (x + y, the block's new state), the
    block under the span ``mamba`` (forward, recompute and backward);
    placed at ``model`` > 1, the states are the rank's blocks on their
    per-layer dims ``dims``. ``t``: a shared block's projected output,
    added to the block's input (not to the residual)."""
    lp = _whole(lp, sh)
    h = L.apply_norm(lp["ln1"], x if t is None else x + t, cfg.norm_kind,
                     cfg.norm_eps)
    y, st = L.traced("mamba", _mixer, (h,), lp["mamba"], cfg, state,
                     return_state, sh, dims)
    return x + y, st


def _shared_call(x, e, leaves, cfg, positions, kv=None, index=None):
    """One call of a shared block (``leaves["block"]``) on RMSNorm([x, e]),
    then the call's adapter and projection (``leaves["call"]``): (t [B, S,
    D], the {"k", "v"} attended over: the sequence's own, or ``kv``, the
    call's cache slot, in a decode step at ``index``)."""
    blk, call = leaves["block"], leaves["call"]
    u = L.apply_norm(blk["ln1"], torch.cat([x, e], dim=-1), cfg.norm_kind,
                     cfg.norm_eps)
    a, kv = L.apply_attention(blk["attn"], u, cfg, positions, cache=kv,
                              cache_index=index)
    h = L.apply_norm(blk["ln2"], a, cfg.norm_kind, cfg.norm_eps)
    m = L.apply_mlp(blk["mlp"], h, cfg, call["adapter"])
    return m @ call["proj"]["w"].to(m.dtype), kv


def _call_shared(blk, call, x, e, cfg, positions, bsh=None, csh=None,
                 kv=None, index=None):
    """``_shared_call`` under the span ``shared``, FSDP blocks gathered."""
    leaves = {"block": _whole(blk, bsh), "call": _whole(call, csh)}
    return L.traced("shared", _shared_call, (x, e), leaves, cfg, positions,
                    kv, index)


# ---------------------------------------------------------------------------
# the stack: one plan, one walk
# ---------------------------------------------------------------------------

def _n_groups(cfg) -> int:
    n = cfg.num_layers // cfg.attn_every
    if n * cfg.attn_every != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into groups of attn_every = {cfg.attn_every}")
    return n


def _plan(cfg: ModelConfig, sh=None) -> list:
    """The stages of ``cfg``'s stack in order, each (kind, a, b): "attn" /
    "ssm" layers a..b-1; "group" groups a..b-1 (group g: Mamba-2 layers
    g E..(g + 1) E - 1, then the shared block, k/v slot g); "call": shared
    call a (k/v slot a), then Mamba layer b with its output. ``sh``: the
    placement (the published block refuses a ``model`` axis)."""
    if cfg.published_hybrid:
        if _tp(sh):
            raise ValueError(f"{cfg.name}: the published Zamba2 block has "
                             f"no tensor-parallel form; its mesh needs model "
                             f"1, got {sh.m}")
        plan, start = [], 0
        for j, i in enumerate(cfg.hybrid_ids):
            plan += [("ssm", start, i)] if i > start else []
            plan.append(("call", j, i))
            start = i + 1
        return plan + ([("ssm", start, cfg.num_layers)]
                       if start < cfg.num_layers else [])
    if cfg.family == "hybrid":
        return [("group", 0, _n_groups(cfg))]
    return [("ssm" if cfg.family == "ssm" else "attn", 0, cfg.num_layers)]


def _layer_params(params, n: int):
    """The stacked layer tree -> one tree per layer. Each stacked leaf is
    unbound once, so its gradient is stacked once."""
    per = [(path, leaf.unbind(0)) for path, leaf in T.flatten(params)]
    return [T.unflatten((path, ls[i]) for path, ls in per) for i in range(n)]


def _stage_shards(sh):
    """(Shards of one stacked layer, of the shared block (one of the
    published ones), of one published call), or Nones unplaced."""
    if sh is None:
        return None, None, None
    if "adapter" not in sh:
        return (sh["layers"].unstacked(),
                sh["shared"] if "shared" in sh else None, None)
    calls = sh._like({k: sh.specs[k] for k in _CALL_LEAVES}).unstacked()
    return sh["layers"].unstacked(), sh["shared"].unstacked(), calls


def _walk(params, cfg, h: list, positions, sh=None, cache=None, index=None,
          keep=False, cache_dim=None, state_dims=None):
    """Run ``_plan(cfg, sh)`` over the hidden state ``h[0]``, a one-element
    list that the walk empties (so a prefill's prompt is freed once the
    first layer's output replaces it): (hidden, aux losses) in training;
    with ``keep``, a prefill, (hidden, (each Mamba layer's state, each
    slot's {"k", "v"})); with ``cache``, one decode step at ``index``
    written into it, (hidden, cache)."""
    plan = _plan(cfg, sh)
    train = cache is None and not keep
    aux = ([torch.zeros((), dtype=torch.float32, device=h[0].device)] * 2
           if train else [])
    e = h[0] if any(kind == "call" for kind, _, _ in plan) else None
    layers = _layer_params(params["layers"], cfg.num_layers)
    if e is not None:
        blocks = _layer_params(params["shared"], cfg.shared_blocks)
        calls = _layer_params({k: params[k] for k in _CALL_LEAVES},
                              len(cfg.hybrid_ids))
    lsh, ssh, csh = _stage_shards(sh)
    states = None if cache is None else cache.get("mamba", cache)
    E = cfg.attn_every
    once = (lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)) \
        if cfg.remat and torch.is_grad_enabled() else (lambda fn, *a: fn(*a))
    kept = ([], [])

    def add(into, got):            # a prefill keeps states and k/v
        if keep:
            into[0].extend(got[0])
            into[1].extend(got[1])

    # an item of a run: (its params, x, its index (None in training), a
    # group's shared block) -> (x, aux losses, its states and k/v if kept)
    def attn(lp, x, i, _=None, sh=lsh):
        kv = None if cache is None else {"k": cache["k"][i],
                                         "v": cache["v"][i]}
        x, a, kv = _transformer_layer(lp, x, cfg, positions, sh, kv, index,
                                      keep, cache_dim)
        return x, a, ([], [kv]) if keep else None

    def ssm(lp, x, i, _=None, t=None):
        state = None if states is None else {k: s[i] for k, s in
                                             states.items()}
        x, st = _ssm_layer(lp, x, cfg, state, keep, lsh, state_dims, t)
        for k, s in (states or {}).items():
            s[i].copy_(st[k])
        return x, {}, ([st], []) if keep else None

    def group(lps, x, g, shared):
        got = ([], [])
        for n, lp in enumerate(lps):
            x, _, o = ssm(lp, x, None if g is None else g * E + n)
            add(got, o)
        x, _, o = attn(shared, x, g, None, ssh)
        add(got, o)
        return x, {}, got if keep else None

    def run(kind, a, b):
        fn = {"attn": attn, "ssm": ssm, "group": group}[kind]
        xs = ([layers[g * E:(g + 1) * E] for g in range(a, b)]
              if kind == "group" else layers[a:b])
        shared = params["shared"] if kind == "group" else None
        if train:          # the carry: (x, moe_aux, moe_z) or (x,)
            def body(c, item, shared, call):
                y, losses, _ = call(fn, item, c[0], None, shared)
                return (y, *(s + losses.get(k, 0.0) for s, k in
                             zip(c[1:], ("moe_aux", "moe_z"))))
            carry = (h.pop(), *aux) if kind == "attn" else (h.pop(),)
            x, *rest = cost.scan(body, carry, xs, shared, cfg.remat)
            aux[:] = rest or aux
        else:
            def step(i, x):
                x, _, got = fn(xs[i], x, a + i, shared)
                return x, got
            x, outs = cost.loop(b - a, step, h.pop())
            for got in outs:
                add(kept, got)
        h.append(x)

    def shared_call(j, i):
        x = h.pop()
        spans.count("shared.calls", 1)
        kv = None if cache is None else {"k": cache["k"][j],
                                         "v": cache["v"][j]}
        t, kv = once(_call_shared, blocks[j % cfg.shared_blocks], calls[j],
                     x, e, cfg, positions, ssh, csh, kv, index)
        if keep:
            kept[1].append({n: kv[n].to(ACT_DTYPE) for n in kv})
        del kv
        x, _, got = once(ssm, layers[i], x, i, None, t)
        add(kept, got)
        h.append(x)

    for kind, a, b in plan:
        if kind == "call":
            shared_call(a, b)
        else:
            run(kind, a, b)
    if train:
        return h.pop(), {"moe_aux": aux[0], "moe_z": aux[1]}
    return h.pop(), kept if keep else cache


def _run_stack(params, cfg, x, positions, sh=None):
    """The training forward of the stack: (hidden, aux losses)."""
    return _walk(params, cfg, [x], positions, sh)


def _emb(params, sh):
    """The embedding leaves, FSDP blocks gathered."""
    return _whole(params["emb"], None if sh is None else sh["emb"])


def _embed(params, tokens, sh):
    emb = _emb(params, sh)
    if _tp(sh):
        return P.embed_tokens(sh["emb"], emb, tokens, ACT_DTYPE)
    return L.embed_tokens(emb, tokens, ACT_DTYPE)


def _logits_last(params, cfg, h, sh):
    emb = _emb(params, sh)
    if _tp(sh):
        return P.logits_last(sh["emb"], emb, h, cfg.vocab_size)
    return L.logits_last(emb, h, cfg.vocab_size)


def _inputs_to_hidden(params, cfg, batch, sh=None):
    """Embed the family's inputs -> (hidden [B,S,D], positions, labels,
    mask). An encoder takes stub frame embeddings ``frames`` [B,S,D] and
    its ``labels`` as given; a vlm prepends stub patch embeddings
    ``patches`` [B,P,D] to its text, with next-token labels over the
    combined sequence and the loss on text positions only (its
    ``loss_mask`` is ignored, as the reference ignores it)."""
    check_family(cfg)
    if cfg.family == "encoder":
        x = batch["frames"].to(ACT_DTYPE)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        return (x, positions, batch["labels"],
                torch.ones((B, S), dtype=torch.bool, device=x.device))
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = _embed(params, tokens, sh)
    text = torch.ones((B, S), dtype=torch.bool, device=dev)
    if cfg.family == "vlm":
        patches = batch["patches"].to(ACT_DTYPE)
        P = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
        tokens = torch.cat([torch.zeros((B, P), dtype=tokens.dtype,
                                        device=dev), tokens], dim=1)
        text = torch.cat([torch.zeros((B, P), dtype=torch.bool, device=dev),
                          text], dim=1)
        S += P
    positions = torch.arange(S, device=dev).expand(B, S)
    pad = torch.zeros((B, 1), dtype=tokens.dtype, device=dev)
    labels = torch.cat([tokens[:, 1:], pad], dim=1)
    mask = text & (torch.arange(S, device=dev) < S - 1)[None, :]
    if "loss_mask" in batch and cfg.family != "vlm":
        mask = mask & batch["loss_mask"].to(torch.bool)
    return x, positions, labels, mask


def forward_logits(params, cfg: ModelConfig, batch):
    """Full-sequence logits [B, S, V] — small models / tests only."""
    x, positions, _, _ = _inputs_to_hidden(params, cfg, batch)
    x, _ = _run_stack(params, cfg, x, positions)
    x = L.apply_norm(params["ln_f"], x, cfg.norm_kind, cfg.norm_eps)
    W = L.unembed_matrix(params["emb"])
    logits = torch.einsum("bsd,vd->bsv", x.to(torch.float32),
                          W.to(torch.float32))
    if cfg.vocab_padded > cfg.vocab_size:
        logits = logits + (torch.arange(cfg.vocab_padded, device=W.device)
                           >= cfg.vocab_size) * -1e30
    return logits


def loss_fn(params, cfg: ModelConfig, batch, sh=None):
    """(mean loss, metrics); ``sh``: the params' placement (this rank's
    blocks), whose rows of the batch ``batch`` is. Placed, the loss and
    metrics are this rank's share of the batch's: its rows' summed CE
    over the batch's counted tokens (rows that pad a short share count
    none), times the number of batch ranks, so that their mean over the
    ranks is the batch's loss whatever each rank holds."""
    x, positions, labels, mask = _inputs_to_hidden(params, cfg, batch, sh)
    count = None
    if sh is not None:
        valid, _ = sh.batch_rows(x.shape[0], x.device)
        mask = mask & valid[:, None]
        count = torch.clamp_min(sh.batch_sum(
            mask.sum().to(torch.float32)), 1.0) / sh.nranks
    x, aux = _run_stack(params, cfg, x, positions, sh)
    x = L.apply_norm(params["ln_f"], x, cfg.norm_kind, cfg.norm_eps)
    if _tp(sh):
        ce = P.chunked_ce_loss(sh["emb"], _emb(params, sh), x, labels, mask,
                               cfg.loss_chunk, vocab_size=cfg.vocab_size,
                               count=count)
    else:
        ce = L.chunked_ce_loss(_emb(params, sh), x, labels, mask,
                               cfg.loss_chunk, vocab_size=cfg.vocab_size,
                               count=count)
    loss = ce + 0.01 * aux["moe_aux"] + 0.001 * aux["moe_z"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# decode: the cache, one step, and the prefill that builds the cache
# ---------------------------------------------------------------------------

def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=ACT_DTYPE,
               device=None):
    """The zeroed decode cache (``device="meta"``: shapes only): k/v
    [n, batch, max_len, K, hd], n the plan's attention layers, groups or
    calls; per-layer SSM states [L, batch, ...] (conv states in ``dtype``,
    h in fp32, no time axis), a hybrid's under "mamba". An encoder has
    none and raises."""
    check_family(cfg)
    _check_decodes(cfg)
    dev = resolve_device(device)
    Lr = cfg.num_layers

    def stacked(state):          # one layer's state -> [L, ...] leaves
        return {k: torch.zeros((Lr, *t.shape), dtype=t.dtype, device=dev)
                for k, t in state.items()}
    if cfg.family == "ssm":
        return stacked(M.mamba1_state(cfg, batch, dtype, "meta"))
    n = sum(1 if kind == "call" else b - a for kind, a, b in _plan(cfg)
            if kind != "ssm")
    kv_shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    kv = lambda: torch.zeros((n, *kv_shape), dtype=dtype, device=dev)
    if cfg.family == "hybrid":
        return {"mamba": stacked(M.mamba2_state(cfg, batch, dtype, "meta")),
                "k": kv(), "v": kv()}
    return {"k": kv(), "v": kv()}


def grow_cache(cfg: ModelConfig, cache, extra: int):
    """Extend a prefill cache's time axis (dim 2 of k/v) by ``extra``
    zeroed decode slots; a new cache, the old one is left as it is. SSM
    states have no time axis and pass through as they are."""
    if extra <= 0 or not isinstance(cache, dict):
        return cache
    grown = dict(cache)
    for name in ("k", "v"):
        if name in grown:
            t = grown[name]
            pad = torch.zeros((*t.shape[:2], extra, *t.shape[3:]),
                              dtype=t.dtype, device=t.device)
            grown[name] = torch.cat([t, pad], dim=2)
    return grown


def _cache_len(cache, cache_dim, sh) -> int:
    """The k/v cache's global length (its time axis is per-layer dim 1)."""
    n = cache["k"].shape[2]
    return n * sh.m if cache_dim == 1 else n


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, tokens, cache, index: int,
               sh=None, cache_dim=None, state_dims=None):
    """One decode step: (logits [B, vocab_padded] fp32, ``cache``, with
    the step's k/v and SSM states written into it in place). tokens: [B]
    int; index: the host int position of this token. Placed (``sh``):
    this rank's rows and blocks of the params and cache (``cache_dim``:
    the per-layer k/v dim on ``model``, 1 for S, 2 for K, 3 for hd, None
    whole; ``state_dims``: {Mamba state leaf: its dim there or None}). An
    index at or past the k/v cache's length raises (the reference clamps
    it onto the last slot); SSM states have no time axis, so no bound."""
    check_family(cfg)
    _check_decodes(cfg)
    if "k" in cache and not 0 <= int(index) < _cache_len(cache, cache_dim,
                                                         sh):
        # before any layer writes its state into the cache
        raise IndexError(f"cache index {index} out of range for a cache "
                         f"of length {_cache_len(cache, cache_dim, sh)}")
    B = tokens.shape[0]
    x = _embed(params, tokens[:, None], sh)                       # [B,1,D]
    positions = torch.full((B, 1), int(index), dtype=torch.int32,
                           device=x.device)
    x, cache = _walk(params, cfg, [x], positions, sh, cache, index,
                     cache_dim=cache_dim, state_dims=state_dims)
    x = L.apply_norm(params["ln_f"], x, cfg.norm_kind, cfg.norm_eps)
    return _logits_last(params, cfg, x[:, 0], sh), cache


def _stack(trees: list) -> dict:
    """Per-layer dicts of tensors -> one dict of stacked leaves."""
    return {k: torch.stack([t[k] for t in trees])
            for k in (trees[0] if trees else ())}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, sh=None, cache_dim=None,
            state_dims=None):
    """Forward the prompt: (logits [B, Vp] at the last position, the
    decode cache for serve_step at max_len = S; an encoder gets none).
    Placed (``sh``): this rank's rows of the batch, and the cache its
    blocks on ``cache_dim`` and ``state_dims`` (as ``serve_step``)."""
    x, positions, _, _ = _inputs_to_hidden(params, cfg, batch, sh)
    h = [x]
    del x
    x, (states, kv) = _walk(params, cfg, h, positions, sh, keep=True,
                            cache_dim=cache_dim, state_dims=state_dims)
    cache = {}
    if _decodes(cfg):            # laid out as make_cache lays it out
        st, kvs = _stack(states), _stack(kv)
        cache = {"mamba": st, **kvs} if st and kvs else st or kvs
    x = L.apply_norm(params["ln_f"], x, cfg.norm_kind, cfg.norm_eps)
    return _logits_last(params, cfg, x[:, -1], sh), cache


# ---------------------------------------------------------------------------
# the tree as an nn.Module
# ---------------------------------------------------------------------------

def _module_of(tree) -> nn.Module:
    mod = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            mod.add_module(k, _module_of(v))
        else:
            mod.register_parameter(
                k, v if isinstance(v, nn.Parameter) else nn.Parameter(v))
    return mod


class Model(nn.Module):
    """A parameter tree held as ``nn.Parameter``s (sharing the tree's
    storage), named by their tree paths (``layers.attn.wq``); ``forward``
    is ``loss_fn`` (placed by ``sh`` when given)."""

    def __init__(self, cfg: ModelConfig, params, sh=None):
        super().__init__()
        self.cfg = cfg
        self.sh = sh
        for k, v in params.items():
            self.add_module(k, _module_of(v))

    def tree(self) -> dict:
        return T.unflatten(self.named_parameters())

    def forward(self, batch):
        return loss_fn(self.tree(), self.cfg, batch, self.sh)
