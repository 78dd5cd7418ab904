"""Model assembly for all six families.

Port of ``repro/models/model.py``: the dense, MoE, ``ssm`` (Mamba-1),
``hybrid`` (Mamba-2 with a shared attention block), ``encoder``
(bidirectional, over stub frame embeddings) and ``vlm`` (a decoder over
``[patches | text]``, the patch embeddings a stub frontend) families:
  init_model(cfg, seed, device) -> (params, specs)  (specs: logical axes)
  loss_fn(params, cfg, batch)    -> (loss, metrics)  (training forward)
  forward_logits(params, cfg, batch) -> [B, S, V]   (small models / tests)
  make_cache(cfg, batch, max_len) -> decode cache: {"k", "v"} [L,B,T,K,hd]
      (dense, MoE, vlm); {"conv", "h"} per layer (ssm); {"mamba": {...},
      "k", "v"} with k/v [n_groups, B, T, K, hd] (hybrid); an encoder
      has no decode step and raises
  grow_cache(cfg, cache, extra)  -> the cache with ``extra`` more slots
  prefill(params, cfg, batch)    -> (last-position logits, cache); an
      encoder's is its inference forward and gives the cache {}
  serve_step(params, cfg, tokens, cache, index) -> (logits [B, V], cache)
  Model(cfg, params)             the same tree held as nn.Parameters

The parameter tree is the reference's: stacked ``[L, ...]`` layer leaves,
``(d_in, d_out)`` weights, the same names; the hybrid's shared block is
one unstacked ``shared`` subtree, applied after every ``attn_every``
layers. The gradient exchange keys a
leaf's coordinates by their position in the flattened stacked leaf and
reseeds each leaf by its index in sorted-key order, and AdamW decays the
leaves with ``ndim >= 2``: per-layer modules would change all three. The
forward loops over the layer axis; ``cfg.remat`` recomputes each layer in
backward (``torch.utils.checkpoint``).

Initialisation draws from an explicit ``torch.Generator``; its bits differ
from threefry's, so parity with the reference goes through
``interop.model_params_from_arrays``.

``ACT_DTYPE`` is read at call time; tests set it to float32, as the
reference's do.

``serve_step`` writes the step's k/v, conv states and h into the cache it
is given and returns that same cache (the reference's serve step donates
its cache); a caller that still needs the old cache clones it first. A
vlm's cache holds the patches first, so its text decodes from index
``frontend_tokens + prompt length``.

An encoder's tree keeps the reference's token embedding ``emb.tok``,
which its frames bypass: its gradient is zero.

Placed params: ``loss_fn``, ``prefill`` and ``serve_step`` take ``sh``, a
``parallel.Shards`` over the tree (this rank's blocks and their pspecs).
Each layer gathers its ``data``-placed (FSDP) leaves inside its
(checkpointed) function, and at a ``model`` axis > 1 the attention, MLP,
MoE, Mamba blocks, embedding and loss run as sums of the ranks' parts
(``models/parallel.py``). Without ``sh`` nothing changes. The decode cache
is then this rank's block too (``cache_dim``: the per-layer dim of k/v on
``model``; ``state_dims``: each Mamba state leaf's, as
``sharding.cache_pspecs`` places them).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.launch import cost
from . import layers as L
from . import mamba as M
from . import moe as MOE
from . import parallel as P
from .config import ModelConfig

ACT_DTYPE = torch.bfloat16

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")


def check_family(cfg: ModelConfig):
    """Raise for a family name the model code does not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         f"known: {FAMILIES}")


def _check_decodes(cfg: ModelConfig):
    if cfg.family == "encoder":
        raise ValueError(f"{cfg.name}: an encoder has no decode step")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(init, cfg, lead=()):
    """An attention + MLP block: (params, specs)."""
    p, s = {}, {}
    p["ln1"], s["ln1"] = L.init_norm(init, cfg.norm_kind, cfg.d_model, lead)
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
    if cfg.family == "hybrid":
        # ONE attention + MLP block shared by every group, unstacked
        p["shared"], s["shared"] = _init_block(init, cfg)
    return p, s


def abstract_params(cfg: ModelConfig):
    """(meta-device parameter tree, spec tree): shapes without drawing or
    allocating anything."""
    return init_model(cfg, device="meta")


# ---------------------------------------------------------------------------
# forward (training) — full sequence
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


def _attend(lp, h, cfg, positions, sh=None):
    if _tp(sh):
        return P.attention(sh["attn"], lp["attn"], h, cfg, positions)[0]
    return L.apply_attention(lp["attn"], h, cfg, positions)[0]


def _transformer_layer(lp, x, cfg, positions, sh=None):
    lp = _whole(lp, sh)
    h = L.apply_norm(lp["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    x = x + _attend(lp, h, cfg, positions, sh)
    h = L.apply_norm(lp["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    m, aux = _ffn(lp, h, cfg, sh)
    return x + m, aux


def _layer_params(params, n: int):
    """The stacked layer tree -> one tree per layer. Each stacked leaf is
    unbound once, so its gradient is stacked once."""
    per = [(path, leaf.unbind(0)) for path, leaf in T.flatten(params)]
    return [T.unflatten((path, ls[i]) for path, ls in per) for i in range(n)]


def _ssm_layer(lp, x, cfg, state=None, return_state=False, sh=None,
               dims=None):
    """Pre-norm residual Mamba layer: (x + y, the block's new state);
    placed at ``model`` > 1, the states are the rank's blocks on their
    per-layer dims ``dims``."""
    lp = _whole(lp, sh)
    h = L.apply_norm(lp["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    if _tp(sh):
        y, st = P.mamba(sh["mamba"], lp["mamba"], h, cfg, state,
                        return_state, dims)
        return x + y, st
    apply = M.apply_mamba1 if cfg.ssm_kind == "mamba1" else M.apply_mamba2
    y, st = apply(lp["mamba"], h, cfg, state=state, return_state=return_state)
    return x + y, st


def _ssm_group(lps, shared, x, cfg, positions, sh=None, shared_sh=None):
    """One hybrid group: ``attn_every`` Mamba-2 layers, then the shared
    attention + MLP block."""
    for lp in lps:
        x, _ = _ssm_layer(lp, x, cfg, sh=sh)
    return _transformer_layer(shared, x, cfg, positions, shared_sh)[0]


def _n_groups(cfg) -> int:
    n = cfg.num_layers // cfg.attn_every
    if n * cfg.attn_every != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into groups of attn_every = {cfg.attn_every}")
    return n


def _layer_shards(sh):
    """(per-layer Shards of the stacked layers, Shards of the hybrid's
    shared block), or (None, None) unplaced."""
    if sh is None:
        return None, None
    return (sh["layers"].unstacked(),
            sh["shared"] if "shared" in sh else None)


def _run_stack(params, cfg, x, positions, sh=None):
    """Loop over the stacked layers; returns (hidden, aux_losses). Each
    layer (a hybrid's group) is recomputed in backward under
    ``cfg.remat``; the loop is ``cost.scan`` (trip-counted in a dry
    run)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _layer_params(params["layers"], cfg.num_layers)
    lsh, ssh = _layer_shards(sh)
    if cfg.family == "ssm":
        def body(c, lp, _, call):
            return (call(_ssm_layer, lp, c[0], cfg, None, False, lsh)[0],)
        return cost.scan(body, (x,), layers, remat=cfg.remat)[0], \
            {"moe_aux": zero, "moe_z": zero}
    if cfg.family == "hybrid":
        E = cfg.attn_every

        def body(c, lps, shared, call):
            return (call(_ssm_group, lps, shared, c[0], cfg, positions, lsh,
                         ssh),)
        groups = [layers[g * E:(g + 1) * E] for g in range(_n_groups(cfg))]
        return cost.scan(body, (x,), groups, params["shared"],
                         cfg.remat)[0], {"moe_aux": zero, "moe_z": zero}

    def body(c, lp, _, call):
        y, a = call(_transformer_layer, lp, c[0], cfg, positions, lsh)
        return (y, c[1] + a.get("moe_aux", 0.0), c[2] + a.get("moe_z", 0.0))
    x, moe_aux, moe_z = cost.scan(body, (x, zero, zero), layers,
                                  remat=cfg.remat)
    return x, {"moe_aux": moe_aux, "moe_z": moe_z}


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
    """The zeroed decode cache (``device="meta"``: shapes only): k/v [L,
    batch, max_len, K, hd]; per-layer SSM states [L, batch, ...] (conv
    states in ``dtype``, h in fp32, no time axis); the hybrid's SSM states
    under "mamba" beside k/v [n_groups, batch, max_len, K, hd]. An
    encoder has none and raises."""
    check_family(cfg)
    _check_decodes(cfg)
    dev = resolve_device(device)
    Lr = cfg.num_layers

    def stacked(state):          # one layer's state -> [L, ...] leaves
        return {k: torch.zeros((Lr, *t.shape), dtype=t.dtype, device=dev)
                for k, t in state.items()}
    if cfg.family == "ssm":
        return stacked(M.mamba1_state(cfg, batch, dtype, "meta"))
    kv_shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    kv = lambda n: torch.zeros((n, *kv_shape), dtype=dtype, device=dev)
    if cfg.family == "hybrid":
        return {"mamba": stacked(M.mamba2_state(cfg, batch, dtype, "meta")),
                "k": kv(_n_groups(cfg)), "v": kv(_n_groups(cfg))}
    return {"k": kv(Lr), "v": kv(Lr)}


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


def _cached_block(lp, x, cfg, positions, ck, cv, index: int, sh=None,
                  cache_dim=None):
    """An attention + MLP block's decode step against the k/v cache of
    one layer (or group), written in place."""
    lp = _whole(lp, sh)
    h = L.apply_norm(lp["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    if _tp(sh):
        a = P.decode_attention(sh["attn"], lp["attn"], h, cfg, positions,
                               ck, cv, index, cache_dim)
    else:
        a, _ = L.apply_attention(lp["attn"], h, cfg, positions,
                                 cache={"k": ck, "v": cv}, cache_index=index)
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    return x + _ffn(lp, h, cfg, sh)[0]


def _ssm_step(lp, x, cfg, states: dict, i: int, sh=None, dims=None):
    """Layer i's Mamba decode step; its new states are written into the
    stacked state leaves ``states`` in place."""
    x, new = _ssm_layer(lp, x, cfg, state={k: t[i] for k, t in
                                            states.items()}, sh=sh,
                        dims=dims)
    for k, t in states.items():
        t[i].copy_(new[k])
    return x


def _cache_len(cache, cache_dim, sh) -> int:
    """The k/v cache's global length (its time axis is per-layer dim 1)."""
    n = cache["k"].shape[2]
    return n * sh.m if cache_dim == 1 else n


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, tokens, cache, index: int,
               sh=None, cache_dim=None, state_dims=None):
    """One decode step. tokens: [B] int; index: the host int position of
    this token (the cache's current length). Placed (``sh``): this rank's
    rows and blocks of the params and cache (``cache_dim``: the per-layer
    k/v dim on ``model``, 1 for S, 2 for K, 3 for hd, None whole;
    ``state_dims``: {Mamba state leaf: its per-layer dim on ``model`` or
    None}).

    Writes the step's k/v and SSM states into ``cache`` in place; returns
    (logits [B, vocab_padded] fp32, cache). An index at or past the k/v
    cache's length raises (the reference clamps it onto the last slot);
    the ssm family has no time axis, so no index bound: a step costs the
    same at any position. An encoder has no decode step and raises."""
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
    layers = _layer_params(params["layers"], cfg.num_layers)
    lsh, ssh = _layer_shards(sh)
    if cfg.family == "ssm":
        def step(i, x):
            return _ssm_step(layers[i], x, cfg, cache, i, lsh,
                             state_dims), None
    elif cfg.family == "hybrid":
        E = cfg.attn_every

        def step(g, x):
            for i in range(g * E, (g + 1) * E):
                x = _ssm_step(layers[i], x, cfg, cache["mamba"], i, lsh,
                              state_dims)
            return _cached_block(params["shared"], x, cfg, positions,
                                 cache["k"][g], cache["v"][g], index, ssh,
                                 cache_dim), None
    else:
        def step(i, x):
            return _cached_block(layers[i], x, cfg, positions, cache["k"][i],
                                 cache["v"][i], index, lsh, cache_dim), None
    n = _n_groups(cfg) if cfg.family == "hybrid" else cfg.num_layers
    x, _ = cost.loop(n, step, x)
    x = L.apply_norm(params["ln_f"], x, cfg.norm_kind, cfg.norm_eps)
    return _logits_last(params, cfg, x[:, 0], sh), cache


def _prefill_block(lp, x, cfg, positions, causal: bool, sh=None,
                   cache_dim=None):
    """An attention + MLP block over the prompt: (x, k, v), k/v in
    ACT_DTYPE for the cache (placed: this rank's block on ``cache_dim``)."""
    B, S, _ = x.shape
    lp = _whole(lp, sh)
    h = L.apply_norm(lp["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    if _tp(sh):
        a, (k, v) = P.attention(sh["attn"], lp["attn"], h, cfg, positions,
                                causal=causal)
        x = x + a
        if cache_dim is not None:
            k, v = (P.block(t, cache_dim, sh) for t in (k, v))
    else:
        q, k, v = L.project_qkv(lp["attn"], h, cfg, positions)
        a = L.chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
        x = x + a.reshape(B, S, -1) @ lp["attn"]["wo"].to(x.dtype)
    h = L.apply_norm(lp["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    return x + _ffn(lp, h, cfg, sh)[0], k.to(ACT_DTYPE), v.to(ACT_DTYPE)


def _stack_states(states: list) -> dict:
    """Per-layer SSM state dicts -> one dict of stacked [L, ...] leaves."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, sh=None, cache_dim=None,
            state_dims=None):
    """Forward the prompt and build the decode cache.

    Returns (logits [B, Vp] for the last position, cache for serve_step at
    max_len = S; an encoder has no decode step and gets no cache). Placed
    (``sh``): this rank's rows of the batch, k/v cut to its block on
    per-layer dim ``cache_dim`` and the Mamba states on ``state_dims``
    (as ``serve_step``)."""
    x, positions, _, _ = _inputs_to_hidden(params, cfg, batch, sh)
    # the loop holds the only reference to the embedded prompt, which is
    # freed once the first layer's output replaces it
    first = [x]
    del x
    layers = _layer_params(params["layers"], cfg.num_layers)
    lsh, ssh = _layer_shards(sh)
    if cfg.family == "ssm":
        def step(i, x):
            return _ssm_layer(layers[i], x, cfg, return_state=True, sh=lsh,
                              dims=state_dims)
        x, states = cost.loop(cfg.num_layers, step, first.pop())
        cache = _stack_states(states)
    elif cfg.family == "hybrid":
        E = cfg.attn_every

        def step(g, x):
            states = []
            for lp in layers[g * E:(g + 1) * E]:
                x, st = _ssm_layer(lp, x, cfg, return_state=True, sh=lsh,
                                   dims=state_dims)
                states.append(st)
            # the reference's hybrid prefill runs the shared block causal
            # with no QKV bias; the hybrid configs have none
            x, k, v = _prefill_block(params["shared"], x, cfg, positions,
                                     True, ssh, cache_dim)
            return x, (states, k, v)
        x, outs = cost.loop(_n_groups(cfg), step, first.pop())
        cache = {"mamba": _stack_states([st for o in outs for st in o[0]]),
                 "k": torch.stack([o[1] for o in outs]),
                 "v": torch.stack([o[2] for o in outs])}
    else:
        def step(i, x):
            x, k, v = _prefill_block(layers[i], x, cfg, positions,
                                     cfg.causal, lsh, cache_dim)
            return x, (k, v)
        x, kv = cost.loop(cfg.num_layers, step, first.pop())
        cache = ({} if cfg.family == "encoder"
                 else {"k": torch.stack([k for k, _ in kv]),
                       "v": torch.stack([v for _, v in kv])})
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
