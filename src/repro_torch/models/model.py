"""Model assembly: the dense and MoE families.

Port of the dense and MoE parts of ``repro/models/model.py``:
  init_model(cfg, seed, device) -> (params, specs)  (specs: logical axes)
  loss_fn(params, cfg, batch)    -> (loss, metrics)  (training forward)
  forward_logits(params, cfg, batch) -> [B, S, V]   (small models / tests)
  make_cache(cfg, batch, max_len) -> decode cache {"k", "v"} [L,B,T,K,hd]
  grow_cache(cfg, cache, extra)  -> the cache with ``extra`` more slots
  prefill(params, cfg, batch)    -> (last-position logits, cache)
  serve_step(params, cfg, tokens, cache, index) -> (logits [B, V], cache)
  Model(cfg, params)             the same tree held as nn.Parameters

The parameter tree is the reference's: stacked ``[L, ...]`` layer leaves,
``(d_in, d_out)`` weights, the same names. The gradient exchange keys a
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

``serve_step`` writes the step's k/v into the cache it is given and
returns that same cache (the reference's serve step donates its cache);
a caller that still needs the old cache clones it first.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch import tree as T
from . import layers as L
from . import moe as MOE
from .config import ModelConfig

ACT_DTYPE = torch.bfloat16

# families whose layers are not ported yet -> what ports them
_NOT_PORTED = {
    "ssm": "models/mamba.py",
    "hybrid": "models/mamba.py and the hybrid stack",
    "encoder": "the encoder branch of models/model.py",
    "vlm": "the vlm branch of models/model.py",
}


def check_family(cfg: ModelConfig):
    """Raise for a family whose layers the port does not have yet."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; "
            f"it waits for {_NOT_PORTED.get(cfg.family, 'its layers')}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, seed: int = 0, device=None):
    """(params, specs) of a dense or MoE model, drawn from ``seed`` on
    ``device`` (default: the card; ``"meta"`` gives shapes only)."""
    check_family(cfg)
    init = L.Init(resolve_device(device), seed)
    lead = (cfg.num_layers,)
    p, s = {}, {}
    p["emb"], s["emb"] = L.init_embedding(init, cfg)
    lp, ls = {}, {}
    lp["ln1"], ls["ln1"] = L.init_norm(init, cfg.norm_kind, cfg.d_model, lead)
    lp["attn"], ls["attn"] = L.init_attention(init, cfg, lead)
    lp["ln2"], ls["ln2"] = L.init_norm(init, cfg.norm_kind, cfg.d_model, lead)
    if cfg.family == "moe":
        lp["moe"], ls["moe"] = MOE.init_moe(init, cfg, lead)
    else:
        lp["mlp"], ls["mlp"] = L.init_mlp(init, cfg, lead=lead)
    p["layers"] = lp
    # the stacked (looped, unsharded) layer axis leads every layer spec
    s["layers"] = T.tree_map(lambda sp: (None,) + tuple(sp), ls)
    p["ln_f"], s["ln_f"] = L.init_norm(init, cfg.norm_kind, cfg.d_model)
    return p, s


def abstract_params(cfg: ModelConfig):
    """(meta-device parameter tree, spec tree): shapes without drawing or
    allocating anything."""
    return init_model(cfg, device="meta")


# ---------------------------------------------------------------------------
# forward (training) — full sequence
# ---------------------------------------------------------------------------

def _ffn(lp, h, cfg):
    """The layer's MLP or MoE block: (out, aux losses)."""
    if "moe" in lp:
        return MOE.apply_moe(lp["moe"], h, cfg)
    return L.apply_mlp(lp["mlp"], h, cfg), {}


def _transformer_layer(lp, x, cfg, positions):
    h = L.apply_norm(lp["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    a, _ = L.apply_attention(lp["attn"], h, cfg, positions)
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    m, aux = _ffn(lp, h, cfg)
    return x + m, aux


def _layer_params(params, n: int):
    """The stacked layer tree -> one tree per layer. Each stacked leaf is
    unbound once, so its gradient is stacked once."""
    per = [(path, leaf.unbind(0)) for path, leaf in T.flatten(params)]
    return [T.unflatten((path, ls[i]) for path, ls in per) for i in range(n)]


def _run_stack(params, cfg, x, positions):
    """Loop over the stacked layers; returns (hidden, aux_losses)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"moe_aux": zero, "moe_z": zero}
    for lp in _layer_params(params["layers"], cfg.num_layers):
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(_transformer_layer, lp, x, cfg, positions,
                              use_reentrant=False)
        else:
            x, a = _transformer_layer(lp, x, cfg, positions)
        aux = {k: aux[k] + a.get(k, 0.0) for k in aux}
    return x, aux


def _inputs_to_hidden(params, cfg, batch):
    """Embed tokens -> (hidden [B,S,D], positions, labels, mask)."""
    check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = L.embed_tokens(params["emb"], tokens, ACT_DTYPE)
    positions = torch.arange(S, device=dev).expand(B, S)
    pad = torch.zeros((B, 1), dtype=tokens.dtype, device=dev)
    labels = torch.cat([tokens[:, 1:], pad], dim=1)
    mask = (torch.arange(S, device=dev) < S - 1)[None, :].expand(B, S)
    if "loss_mask" in batch:
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


def loss_fn(params, cfg: ModelConfig, batch):
    x, positions, labels, mask = _inputs_to_hidden(params, cfg, batch)
    x, aux = _run_stack(params, cfg, x, positions)
    x = L.apply_norm(params["ln_f"], x, cfg.norm_kind, cfg.norm_eps)
    ce = L.chunked_ce_loss(params["emb"], x, labels, mask, cfg.loss_chunk,
                           vocab_size=cfg.vocab_size)
    loss = ce + 0.01 * aux["moe_aux"] + 0.001 * aux["moe_z"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# decode: the cache, one step, and the prefill that builds the cache
# ---------------------------------------------------------------------------

def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=ACT_DTYPE,
               device=None):
    """Zeroed k/v caches [L, batch, max_len, K, hd] (``device="meta"``:
    shapes only)."""
    check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def grow_cache(cfg: ModelConfig, cache, extra: int):
    """Extend a prefill cache's time axis (dim 2) by ``extra`` zeroed
    decode slots; a new cache, the old one is left as it is."""
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


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, tokens, cache, index: int):
    """One decode step. tokens: [B] int; index: the host int position of
    this token (the cache's current length).

    Writes the step's k/v into ``cache`` in place; returns (logits
    [B, vocab_padded] fp32, cache). An index at or past the cache's length
    raises (the reference clamps it onto the last slot)."""
    check_family(cfg)
    B = tokens.shape[0]
    x = L.embed_tokens(params["emb"], tokens[:, None], ACT_DTYPE)  # [B,1,D]
    positions = torch.full((B, 1), int(index), dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(_layer_params(params["layers"], cfg.num_layers)):
        h = L.apply_norm(lp["ln1"], x, cfg.norm_kind, cfg.norm_eps)
        a, _ = L.apply_attention(lp["attn"], h, cfg, positions,
                                 cache={"k": cache["k"][i],
                                        "v": cache["v"][i]},
                                 cache_index=index)
        x = x + a
        h = L.apply_norm(lp["ln2"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + _ffn(lp, h, cfg)[0]
    x = L.apply_norm(params["ln_f"], x, cfg.norm_kind, cfg.norm_eps)
    return L.logits_last(params["emb"], x[:, 0], cfg.vocab_size), cache


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch):
    """Forward the prompt and build the decode cache.

    Returns (logits [B, Vp] for the last position, cache for serve_step at
    max_len = S; an encoder has no decode step and gets no cache)."""
    x, positions, _, _ = _inputs_to_hidden(params, cfg, batch)
    B, S, _ = x.shape
    ks, vs = [], []
    for lp in _layer_params(params["layers"], cfg.num_layers):
        h = L.apply_norm(lp["ln1"], x, cfg.norm_kind, cfg.norm_eps)
        q, k, v = L.project_qkv(lp["attn"], h, cfg, positions)
        a = L.chunked_attention(q, k, v, causal=cfg.causal,
                                chunk=cfg.attn_chunk)
        x = x + a.reshape(B, S, -1) @ lp["attn"]["wo"].to(x.dtype)
        h = L.apply_norm(lp["ln2"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + _ffn(lp, h, cfg)[0]
        ks.append(k.to(ACT_DTYPE))
        vs.append(v.to(ACT_DTYPE))
    cache = ({} if cfg.family == "encoder"
             else {"k": torch.stack(ks), "v": torch.stack(vs)})
    x = L.apply_norm(params["ln_f"], x, cfg.norm_kind, cfg.norm_eps)
    return L.logits_last(params["emb"], x[:, -1], cfg.vocab_size), cache


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
    is ``loss_fn``."""

    def __init__(self, cfg: ModelConfig, params):
        super().__init__()
        self.cfg = cfg
        for k, v in params.items():
            self.add_module(k, _module_of(v))

    def tree(self) -> dict:
        return T.unflatten(self.named_parameters())

    def forward(self, batch):
        return loss_fn(self.tree(), self.cfg, batch)
