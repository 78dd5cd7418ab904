"""Plain float32 PyTorch reference of the benchmark's language models: the
training loss of the ``moe`` family (granite-moe: GQA attention with RoPE
and a top-k mixture of SwiGLU experts under a per-row capacity) and of the
``hybrid`` family (zamba2: Mamba-2 layers with one attention + MLP block
shared by every group of ``attn_every`` layers).

Written from the published descriptions, in plain operations: attention as
softmax(q k^T / sqrt(hd)) v over the whole causal square, one row at a
time; the experts one at a time over the tokens routed to them; the SSD
scan as the chunked dual form of the Mamba-2 paper (its ``ssd_minimal``);
the loss as the whole vocabulary's log-softmax. Each layer is recomputed
in backward (``torch.utils.checkpoint``) so that a step at the timed sizes
fits on one card. It imports nothing of the program.

Where the program departs from the published model, the reference follows
the program's model, so that the two compute the same function:
  * no scalar multipliers (granite's embedding, attention, residual and
    logit multipliers) and no MoE shared expert;
  * a choice past its expert's capacity C = 8 ceil(ceil(S k 1.25 / E) / 8)
    is dropped, counted over a row's choices in (position, rank) order;
    the loss adds 0.01 x the summed load-balancing loss E sum(mean gate x
    mean routed share) and 0.001 x the summed router z-loss;
  * zamba2's shared block takes the hidden state alone (no concatenated
    embedding, no LoRA adapters), after every ``attn_every``-th layer, and
    its output embedding is untied.

``quant``: a rounding applied wherever the program holds a value in its
stated compute precision (bfloat16): both operands and the result of
every weight-matrix product (projections, router, experts, the output
head's input), the embedded tokens, the norms' outputs, q and k after
RoPE, the residual stream after each add and the MoE block's output;
``fp8`` below rounds to float8 e4m3, the control's precision.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale (amax -> 448),
    in the forward pass; the backward passes the gradient straight
    through."""
    scale = torch.clamp_min(t.detach().abs().amax(), 1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return t + (q - t.detach())


def _q(t, quant):
    return t if quant is None else quant(t)


def _mm(x, w, quant):
    if quant is None:
        return x @ w
    return quant(quant(x) @ quant(w))


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x [B, S, H, hd]: the two halves of each head rotated by position."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(h, wq, wk, wv, wo, cfg, quant):
    B, S, _ = h.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _q(_rope(_mm(h, wq, quant).view(B, S, H, hd), cfg.rope_theta),
           quant)
    k = _q(_rope(_mm(h, wk, quant).view(B, S, K, hd), cfg.rope_theta),
           quant)
    v = _mm(h, wv, quant).view(B, S, K, hd)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    keep = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    rows = []
    for b in range(B):
        s = torch.einsum("shd,thd->hst", q[b], k[b]) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        rows.append(torch.einsum("hst,thd->shd", p, v[b]))
    return _mm(torch.stack(rows).reshape(B, S, H * hd), wo, quant)


def swiglu(h, wi, wg, wo, quant):
    return _mm(_mm(h, wi, quant) * F.silu(_mm(h, wg, quant)), wo, quant)


def capacity(S: int, cfg) -> int:
    c = math.ceil(S * cfg.moe_top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8 * math.ceil(c / 8), 8)


def moe(h, router, wi, wg, wo, cfg, quant):
    """(out, load-balancing loss, z-loss) of one MoE block."""
    B, S, D = h.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    logits = _mm(h, router, quant)                          # [B, S, E]
    gates = torch.softmax(logits, dim=-1)
    top = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = top.values[..., :k], top.indices[..., :k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    chosen = F.one_hot(topi, E)                             # [B, S, k, E]
    # a choice's slot: the row's earlier choices of its expert
    order = chosen.reshape(B, S * k, E)
    slot = ((order.cumsum(1) - 1) * order).sum(-1).reshape(B, S, k)
    kept = slot < capacity(S, cfg)
    flat = h.reshape(B * S, D)
    out = torch.zeros_like(flat)
    for e in range(E):
        mine = (topi == e) & kept                           # [B, S, k]
        rows = mine.any(-1).reshape(-1).nonzero().squeeze(1)
        if rows.numel() == 0:
            continue
        gate = (topv * mine).sum(-1).reshape(-1)[rows]
        y = swiglu(flat[rows], wi[e], wg[e], wo[e], quant)
        out = out.index_add(0, rows, y * gate[:, None])
    out = _q(out, quant)
    me = gates.mean((0, 1))
    ce = chosen.sum(2).to(F32).mean((0, 1))
    aux = E * (me * ce).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return out.reshape(B, S, D), aux, z


def _conv(x, w, b):
    """Depthwise causal conv: x [B, S, C], w [C, K], b [C]."""
    K = w.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    return sum(xp[:, j:j + S] * w[:, j] for j in range(K)) + b


def _segsum(a):
    """a [..., T] -> [..., T, T]: sum a[j+1..i] at (i, j), -inf above the
    diagonal."""
    T = a.shape[-1]
    c = a.cumsum(-1)
    d = c[..., :, None] - c[..., None, :]
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return d.masked_fill(~keep, float("-inf"))


def ssd(X, A, Bm, Cm, chunk: int):
    """The Mamba-2 paper's chunked SSD from a zero state. X [B, S, H, P]
    (inputs times dt), A [B, S, H] (dt times the head's A), Bm and Cm
    [B, S, N] (one group for every head). Returns Y [B, S, H, P]."""
    Bsz, S, H, P = X.shape
    nC = max(S // chunk, 1)
    L = S // nC
    X = X.reshape(Bsz, nC, L, H, P)
    Bm = Bm.reshape(Bsz, nC, L, -1)
    Cm = Cm.reshape(Bsz, nC, L, -1)
    A = A.reshape(Bsz, nC, L, H).permute(0, 3, 1, 2)        # [B, H, c, l]
    Acum = A.cumsum(-1)
    decay = torch.exp(_segsum(A))                           # [B,H,c,l,s]
    cb = torch.einsum("bcln,bcsn->bcls", Cm, Bm)
    W = cb[:, None] * decay                                 # [B,H,c,l,s]
    Y = torch.einsum("bhcls,bcshp->bclhp", W, X)
    into = torch.exp(Acum[..., -1:] - Acum)                 # [B, H, c, l]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bm, into, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(_segsum(F.pad(Acum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    Y = Y + torch.einsum("bcln,bchpn,bhcl->bclhp", Cm, states,
                         torch.exp(Acum))
    return Y.reshape(Bsz, S, H, P)


def mamba2(h, p, cfg, quant):
    """One Mamba-2 block over h [B, S, D]; ``p`` this layer's leaves."""
    B, S, _ = h.shape
    H, P = cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim
    z = _mm(h, p["wz"], quant)
    xs = F.silu(_conv(_mm(h, p["wx"], quant), p["conv_x"], p["conv_xb"]))
    Bm = F.silu(_conv(_mm(h, p["wB"], quant), p["conv_B"], p["conv_Bb"]))
    Cm = F.silu(_conv(_mm(h, p["wC"], quant), p["conv_C"], p["conv_Cb"]))
    dt = F.softplus(_mm(h, p["wdt"], quant) + p["dt_bias"])  # [B, S, H]
    x = xs.view(B, S, H, P)
    y = ssd(x * dt[..., None], dt * -torch.exp(p["A_log"]), Bm, Cm,
            cfg.ssm_chunk)
    y = (y + x * p["D"][:, None]).reshape(B, S, H * P) * F.silu(z)
    y = _rms(y, p["norm_scale"], cfg.norm_eps)
    return _mm(y, p["out_proj"], quant)


def _layer(W, prefix, i):
    """{leaf name: layer i's slice} of the stacked leaves under prefix."""
    n = len(prefix)
    return {k[n:]: v[i] for k, v in W.items() if k.startswith(prefix)}


def _block(W, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in W.items() if k.startswith(prefix)}


def _attn_mlp(x, p, cfg, quant):
    """Pre-norm attention + MLP (or MoE) block: (x, aux, z)."""
    h = _q(_rms(x, p["ln1.scale"], cfg.norm_eps), quant)
    x = _q(x + attention(h, p["attn.wq"], p["attn.wk"], p["attn.wv"],
                         p["attn.wo"], cfg, quant), quant)
    h = _q(_rms(x, p["ln2.scale"], cfg.norm_eps), quant)
    if "moe.router" in p:
        m, aux, z = moe(h, p["moe.router"], p["moe.wi"], p["moe.wg"],
                        p["moe.wo"], cfg, quant)
        return _q(x + m, quant), aux, z
    zero = x.new_zeros(())
    return _q(x + swiglu(h, p["mlp.wi"], p["mlp.wg"], p["mlp.wo"], quant),
              quant), zero, zero


def _row_ce(h, W, tokens, vocab):
    """Summed next-token CE of one row: h [S, D], tokens [S]."""
    logits = h[:-1] @ W.t()
    logits = logits.masked_fill(
        torch.arange(W.shape[0], device=h.device) >= vocab, float("-inf"))
    return F.cross_entropy(logits, tokens[1:].long(), reduction="sum")


def loss(W: dict, cfg, tokens: torch.Tensor, quant=None):
    """Mean next-token CE over tokens [B, S] (the last position has no
    label) + the MoE losses: (loss, ce)."""
    B, S = tokens.shape
    x = _q(W["emb.tok"][tokens.long()], quant)
    aux = z = x.new_zeros(())
    run = lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)
    if cfg.family == "moe":
        for i in range(cfg.num_layers):
            x, a, zz = run(lambda x, p: _attn_mlp(x, p, cfg, quant), x,
                           _layer(W, "layers.", i))
            aux, z = aux + a, z + zz
    elif cfg.family == "hybrid":
        shared = _block(W, "shared.")
        for i in range(cfg.num_layers):
            p = _layer(W, "layers.", i)
            x = run(lambda x, p: _q(x + mamba2(
                _q(_rms(x, p["ln1.scale"], cfg.norm_eps), quant),
                _block(p, "mamba."), cfg, quant), quant), x, p)
            if (i + 1) % cfg.attn_every == 0:
                x = run(lambda x, p: _attn_mlp(x, p, cfg, quant)[0], x,
                        shared)
    else:
        raise ValueError(f"no reference for the family {cfg.family!r}")
    # the output head runs in float32 on the final norm's output
    x = _q(_rms(x, W["ln_f.scale"], cfg.norm_eps), quant)
    head = W.get("emb.out", W["emb.tok"])
    total = sum(run(lambda h, t: _row_ce(h, head, t, cfg.vocab_size),
                    x[b], tokens[b]) for b in range(B))
    ce = total / (B * (S - 1))
    return ce + 0.01 * aux + 0.001 * z, ce
