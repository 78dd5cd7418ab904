"""Mixture-of-Experts block (granite-moe, qwen2-moe).

Port of ``repro/models/moe.py``. Dispatch is capacity-based scatter/gather
(GShard-style semantics) without a [T, E, C] one-hot dispatch product:
each token's top-k choices take slots from a per-row running count of
expert choices (``kernels/moe_slots.py``: K8 on the card), and tokens
move to [B, E*C, D] expert buffers and back by index. Routing is the
reference's to the bit:

  * top-k breaks ties lowest expert index first, as ``lax.top_k`` does
    (a stable descending sort; ``torch.topk`` promises no tie order, and
    bf16 router logits tie often);
  * a choice past its expert's capacity C goes to a spare slot E*C, the
    reference's out-of-bounds "drop" index: the buffers carry one spare
    row, sliced off before the experts run, and it reads back as 0.

Kept destinations are unique, so the ``index_add`` into the buffers adds
each token onto zeros (exact and order-free on the card); only the spare
row takes collisions. The expert FFN is a batched product over E, as the
reference's einsum.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_slots import expert_slots
from repro_torch.telemetry import spans

from .layers import Init, apply_mlp, dense_init, init_mlp


def moe_capacity(tokens_per_row: int, cfg) -> int:
    c = math.ceil(tokens_per_row * cfg.moe_top_k * cfg.capacity_factor
                  / cfg.num_experts)
    return max(8 * math.ceil(c / 8), 8)  # lane-aligned


def _n_experts(cfg) -> int:
    return max(cfg.num_experts_padded, cfg.num_experts)


def init_moe(init: Init, cfg, lead=()):
    d, f, E = cfg.d_model, cfg.d_ff, _n_experts(cfg)
    p, s = {}, {}
    p["router"], s["router"] = dense_init(init, d, E, ("embed", None), lead)
    p["wi"] = init.normal((*lead, E, d, f), 1.0 / math.sqrt(d))
    p["wg"] = init.normal((*lead, E, d, f), 1.0 / math.sqrt(d))
    p["wo"] = init.normal((*lead, E, f, d), 1.0 / math.sqrt(f))
    s["wi"] = ("expert", "embed", "mlp")
    s["wg"] = ("expert", "embed", "mlp")
    s["wo"] = ("expert", "mlp", "embed")
    if cfg.num_shared_experts:
        p["shared"], s["shared"] = init_mlp(
            init, cfg, d_ff=cfg.num_shared_experts * cfg.d_ff, lead=lead)
    return p, s


class Routing(NamedTuple):
    """Where each of a row's S*k choices goes. logits/gates [B,S,E] fp32;
    topv (renormalised) / topi [B,S,k]; slot, keep, dest [B,S*k]."""
    logits: torch.Tensor
    gates: torch.Tensor
    topv: torch.Tensor
    topi: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor


def route(p, x, cfg) -> Routing:
    """The router, top-k and slot assignment of ``apply_moe``."""
    B, S, _ = x.shape
    E, k = _n_experts(cfg), cfg.moe_top_k
    C = moe_capacity(S, cfg)
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)   # [B,S,E]
    if E > cfg.num_experts:  # padded experts are masked out of routing
        logits = logits + (torch.arange(E, device=x.device)
                           >= cfg.num_experts) * -1e30
    gates = torch.softmax(logits, dim=-1)
    srt = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = srt.values[..., :k], srt.indices[..., :k]
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    # slots: the running count of earlier choices of the same expert over
    # the row's flattened (S*k) choices (K8 on the card)
    slot, keep, dest = expert_slots(topi.reshape(B, S * k), E, C)
    return Routing(logits, gates, topv, topi, slot, keep, dest)


def apply_moe(p, x, cfg, sh=None):
    """x: [B, S, D] -> ([B, S, D], aux_losses dict). Placed (``sh``, a
    ``parallel.Shards``; x this rank's rows): the load-balancing loss
    takes the batch's mean gates and routed fractions, and with a
    ``model`` axis > 1 routing and its losses run on every rank, then the
    sum of the ranks' parts (see ``models/parallel.py``)."""
    B, S, D = x.shape
    E, k = _n_experts(cfg), cfg.moe_top_k
    with spans.span("moe.route", x):
        r = route(p, x, cfg)
    if spans.recording() and torch._C._current_graph_task_id() < 0:
        # the buffers' fill in the forward (remat's recompute runs inside
        # backward's graph task, and is not counted again)
        spans.count("moe.kept", r.keep)
        spans.count("moe.slots", B * E * moe_capacity(S, cfg))

    # --- load-balancing + z losses (Switch-style) ---
    routed = F.one_hot(r.topi, E).sum(2).to(torch.float32)     # [B,S,E]
    z = torch.logsumexp(r.logits, dim=-1) ** 2
    if sh is None:
        me = torch.mean(r.gates, dim=(0, 1))                    # [E]
        ce = torch.mean(routed, dim=(0, 1))                     # frac routed
        z_loss = torch.mean(z)
    else:
        # the batch's means over its real tokens, not the rank's rows':
        # padding rows weigh zero; z is the rank's share (``loss_fn``)
        valid, total = sh.batch_rows(B, x.device)
        w = valid.to(torch.float32)[:, None]
        n = float(total * S)
        me = sh.batch_sum(torch.sum(r.gates * w[..., None], dim=(0, 1))) / n
        ce = sh.batch_sum(torch.sum(routed * w[..., None], dim=(0, 1))) / n
        z_loss = torch.sum(z * w) * sh.nranks / n
    aux_loss = E * torch.sum(me * ce)
    aux = {"moe_aux": aux_loss, "moe_z": z_loss}
    if sh is not None and sh.tp:
        return _parallel_moe(sh, p, x, cfg, r), aux

    expert_in, flat = _dispatch(x, r, cfg)
    out = _combine(_experts(p, expert_in), r.topv, r, flat, x)
    if cfg.num_shared_experts:
        out = out + apply_mlp(p["shared"], x, cfg)
    return out, aux


def _dispatch(x, r: Routing, cfg):
    """Tokens scattered to [B, E, C, D] expert buffers, and each choice's
    flat row in the [B * (E*C + 1), D] buffers with a spare drop row."""
    B, S, D = x.shape
    E, k = _n_experts(cfg), cfg.moe_top_k
    C = moe_capacity(S, cfg)
    rows = E * C + 1
    flat = (r.dest + rows * torch.arange(B, device=x.device)[:, None]
            ).reshape(-1)
    xk = x.repeat_interleave(k, dim=1).reshape(B * S * k, D)  # [B*S*k, D]
    buf = torch.zeros((B * rows, D), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, flat, xk).reshape(B, rows, D)
    return buf[:, :-1].reshape(B, E, C, D), flat


def _experts(p, expert_in):
    """The experts' SwiGLU FFN over their buffers [B, E', C, D]."""
    dt = expert_in.dtype
    h = torch.einsum("becd,edf->becf", expert_in, p["wi"].to(dt))
    g = torch.einsum("becd,edf->becf", expert_in, p["wg"].to(dt))
    h = F.silu(g) * h
    return torch.einsum("becf,efd->becd", h, p["wo"].to(dt))


def _combine(expert_out, topv, r: Routing, flat, x):
    """Gather the experts' outputs back (the spare row reads 0) and weight
    each kept choice by its gate."""
    B, S, D = x.shape
    k = r.topi.shape[-1]
    dt = x.dtype
    padded = torch.cat([expert_out.reshape(B, -1, D),
                        torch.zeros((B, 1, D), dtype=dt, device=x.device)],
                       dim=1)
    back = padded.reshape(-1, D).index_select(0, flat)
    wts = (topv.reshape(B, S * k) * r.keep.to(torch.float32)).to(dt)
    return (back.reshape(B, S * k, D) * wts[..., None]).reshape(
        B, S, k, D).sum(dim=2)


def _parallel_moe(sh, p, x, cfg, r: Routing):
    """The experts as a sum over ``model``: each rank runs its experts
    over all tokens (``expert`` placed on ``model``), or every expert over
    its d_ff columns (``mlp`` on ``model``), or (neither divides) a ragged
    share of the experts; the shared experts are an MLP part."""
    from repro_torch.launch.mesh import copy_to, reduce_from
    from . import parallel as P
    x = copy_to(sh.mesh, "model", x)
    topv = copy_to(sh.mesh, "model", r.topv)
    expert_in, flat = _dispatch(x, r, cfg)
    E = expert_in.shape[1]
    if sh.model_dim("wi") == 2:                   # d_ff on model
        out = _experts(p, expert_in)
    else:
        parts = P.ranges(E, sh.m)
        lo, hi = parts[sh.r]
        mine = {n: P.take(sh, n, p[n], 0, parts) for n in ("wi", "wg", "wo")}
        out = F.pad(_experts(mine, expert_in[:, lo:hi]),
                    (0, 0, 0, 0, lo, E - hi))
    out = _combine(out, topv, r, flat, x)
    if cfg.num_shared_experts:
        out = out + P.mlp_part(sh["shared"], p["shared"], x, cfg)
    return reduce_from(sh.mesh, "model", out)
