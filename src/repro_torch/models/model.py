"""Model assembly: the dense family.

Port of the dense parts of ``repro/models/model.py``:
  init_model(cfg, seed, device) -> (params, specs)  (specs: logical axes)
  loss_fn(params, cfg, batch)    -> (loss, metrics)  (training forward)
  forward_logits(params, cfg, batch) -> [B, S, V]   (small models / tests)
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
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch import tree as T
from . import layers as L
from .config import ModelConfig

ACT_DTYPE = torch.bfloat16

# families whose layers are not ported yet -> the ROADMAP item that ports them
_NOT_PORTED = {
    "moe": "ROADMAP A.5 (models/moe.py)",
    "ssm": "ROADMAP A.5 (models/mamba.py)",
    "hybrid": "ROADMAP A.5 (models/mamba.py and the hybrid stack)",
    "encoder": "ROADMAP A.5 (the encoder branch of models/model.py)",
    "vlm": "ROADMAP A.5 (the vlm branch of models/model.py)",
}


def check_family(cfg: ModelConfig):
    """Raise for a family whose layers the port does not have yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; "
            f"{_NOT_PORTED.get(cfg.family, 'ROADMAP A.5')} ports it")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, seed: int = 0, device=None):
    """(params, specs) of a dense model, drawn from ``seed`` on ``device``
    (default: the card; ``"meta"`` gives shapes only)."""
    check_family(cfg)
    init = L.Init(resolve_device(device), seed)
    lead = (cfg.num_layers,)
    p, s = {}, {}
    p["emb"], s["emb"] = L.init_embedding(init, cfg)
    lp, ls = {}, {}
    lp["ln1"], ls["ln1"] = L.init_norm(init, cfg.norm_kind, cfg.d_model, lead)
    lp["attn"], ls["attn"] = L.init_attention(init, cfg, lead)
    lp["ln2"], ls["ln2"] = L.init_norm(init, cfg.norm_kind, cfg.d_model, lead)
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

def _transformer_layer(lp, x, cfg, positions):
    h = L.apply_norm(lp["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    a, _ = L.apply_attention(lp["attn"], h, cfg, positions)
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    return x + L.apply_mlp(lp["mlp"], h, cfg)


def _run_stack(params, cfg, x, positions):
    """Loop over the stacked layers; returns (hidden, aux_losses). Each
    stacked leaf is unbound once, so its gradient is stacked once."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    per = [(path, leaf.unbind(0)) for path, leaf in T.flatten(params["layers"])]
    for i in range(cfg.num_layers):
        lp = T.unflatten((path, ls[i]) for path, ls in per)
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_transformer_layer, lp, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _transformer_layer(lp, x, cfg, positions)
    return x, {"moe_aux": zero, "moe_z": zero}


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
