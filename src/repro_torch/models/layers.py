"""Foundational layers of the dense, MoE, SSM and hybrid families.

Port of ``repro/models/layers.py``. Conventions:
  * activations [batch, seq, ...]; params are nested dicts of tensors,
    stacked along a leading layer axis where ``lead`` says so, with the
    reference's ``(d_in, d_out)`` weight layout and names;
  * every ``init_*`` returns (params, specs), where specs mirrors params
    with tuples of LOGICAL axis names (``launch/sharding.py`` maps them to
    mesh axes);
  * attention is chunked online softmax with a hand-written backward
    (``torch.autograd.Function``) that saves only (out, lse) and
    recomputes the score tiles, in the reference's arithmetic: fp32
    scores, fp32 accumulation; on the card as the fused kernels of K7
    (``kernels/attention.py``), elsewhere as K7's plain loop, chunk by
    chunk;
  * the cross-entropy is taken chunk by chunk over the sequence, each
    chunk recomputed in backward, so the full [B, S, V] logits never
    exist at once;
  * decode attends one new token over the whole cache in one einsum
    (``decode_attention``), and the cache branch of ``apply_attention``
    writes the step's k/v into the cache IN PLACE (the reference's serve
    step donates its cache, so its old cache is gone too).

The reference's ``shard_heads`` is a GSPMD layout hint. The port places
blocks explicitly (``models/parallel.py``), so here it states and checks
the layout a rank holds and changes no number. (The reference's
``shard_tokens`` pins activations to the batch axes; the port's train step
takes each rank's share of the batch itself, ``launch/steps.py``.)
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.kernels import attention as KA
from repro_torch.telemetry import spans

_NEG = -1e30


# ---------------------------------------------------------------------------
# param declaration helpers
# ---------------------------------------------------------------------------

class Init:
    """Where parameters are drawn and from what: a seeded generator on a
    device, or the meta device (shapes only, nothing drawn)."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def normal(self, shape, scale: float) -> torch.Tensor:
        """``scale`` x a standard normal truncated to [-2, 2], float32."""
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.gen is None:
            return t
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=self.gen)
        return t.mul_(scale)

    def gaussian(self, shape, scale: float) -> torch.Tensor:
        """``scale`` x an untruncated standard normal, float32."""
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.gen is None:
            return t
        return t.normal_(generator=self.gen).mul_(scale)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        """Uniform on [lo, hi), float32."""
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.gen is None:
            return t
        return t.uniform_(lo, hi, generator=self.gen)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)


def dense_init(init: Init, d_in, d_out, spec, lead=(), scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return init.normal((*lead, d_in, d_out), scale), spec


def shard_heads(x, enabled: bool, mesh=None, heads=None):
    """The reference pins [B, S, H, hd] q/k/v to heads on ``model`` when the
    head count divides it. With ``enabled``, this checks that a rank then
    holds its equal block of the ``heads`` global heads, and returns ``x``
    as it is."""
    if enabled and mesh is not None and heads is not None and x.ndim == 4:
        m = mesh.shape.get("model", 1)
        if heads % m == 0 and x.shape[2] != heads // m:
            raise ValueError(f"{x.shape[2]} heads on a rank, expected "
                             f"{heads // m} of {heads} over {m}")
    return x


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(init: Init, kind: str, d: int, lead=()):
    ones = init.full((*lead, d), 1.0)
    if kind == "rmsnorm":
        return {"scale": ones}, {"scale": (None,)}
    return ({"scale": ones, "bias": init.full((*lead, d), 0.0)},
            {"scale": (None,), "bias": (None,)})


def apply_norm(params, x, kind: str, eps: float):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        out = ((xf - mu) * torch.rsqrt(var + eps) * params["scale"]
               + params["bias"])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: [B, S, H, hd]; positions: [B, S] (int). Halves rotated."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].to(torch.float32) * freqs       # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked online-softmax attention with a recomputing backward
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse); backward recomputes each score
    tile from them (never an [S, S] tensor at once). CUDA tensors run K7
    (``kernels/attention.py``), others its plain loop."""

    @staticmethod
    def forward(ctx, q, k, v, causal, Cq, Ck, q_offset, kv_valid_len,
                scale):
        with spans.span("attn", q):
            out, lse = KA.attention_forward(q, k, v, causal, Cq, Ck,
                                            q_offset, kv_valid_len, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan = (causal, Cq, Ck, q_offset, kv_valid_len, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with spans.span("attn", do):
            dq, dk, dv = KA.attention_backward(q, k, v, out, lse, do,
                                               *ctx.plan)
        return dq, dk, dv, None, None, None, None, None, None


def chunked_attention(q, k, v, *, causal: bool, chunk: int, q_offset=0,
                      kv_valid_len=None, scale=None):
    """q: [B,Sq,H,hd], k/v: [B,Sk,K,hd] (GQA: H = K*G). Returns
    [B,Sq,H,hd]. ``q_offset`` / ``kv_valid_len`` are host ints (training
    uses 0 / None); ``scale``: the softmax scale (None: 1 / sqrt(hd))."""
    Sq, Sk = q.shape[1], k.shape[1]
    Cq, Ck = min(chunk, Sq), min(chunk, Sk)
    if (Sq // Cq) * Cq != Sq or (Sk // Ck) * Ck != Sk:
        raise ValueError("seq must divide by chunk")
    return _FlashAttention.apply(
        q, k, v, bool(causal), Cq, Ck, int(q_offset),
        None if kv_valid_len is None else int(kv_valid_len), scale)


def attn_scale(cfg):
    """The configuration's softmax scale, or None for 1 / sqrt(head_dim)."""
    return cfg.attn_scale or None


class _Edge:
    """The backward span of one ``traced`` call: opened when its output's
    gradient arrives (``_EdgeOut``), closed once every input's gradient is
    complete (``_EdgeIn``)."""

    def __init__(self, name: str):
        self.name, self.held = name, None

    def open(self, on):
        self.held = spans.span(self.name, on)
        self.held.__enter__()

    def close(self):
        if self.held is not None:
            self.held.__exit__(None, None, None)
            self.held = None


class _EdgeOut(torch.autograd.Function):
    """Identity on a block's output; its backward opens the block's span."""

    @staticmethod
    def forward(ctx, edge, y):
        ctx.edge = edge
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        ctx.edge.open(dy)
        return None, dy


class _EdgeIn(torch.autograd.Function):
    """Identity on a block's inputs; its backward closes the block's span."""

    @staticmethod
    def forward(ctx, edge, *ts):
        ctx.edge = edge
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        ctx.edge.close()
        return (None, *gs)


def traced(name: str, fn, xs: tuple, leaves: dict, *args):
    """``fn(*xs, leaves, *args)`` recorded as the span ``name``: its
    forward (and remat's recompute, which runs it again) inside the span,
    and its backward, from its output's gradient to its inputs', inside
    another. ``fn`` gives the block's output, or a tuple that leads with
    it; ``xs`` and the tree of tensors ``leaves`` are the inputs whose
    gradients close the backward's span."""
    if not torch.is_grad_enabled() or not spans.recording():
        with spans.span(name, xs[0]):
            return fn(*xs, leaves, *args)
    edge = _Edge(name)
    flat = T.flatten(leaves)
    ins = _EdgeIn.apply(edge, *xs, *(t for _, t in flat))
    xs, ts = ins[:len(xs)], ins[len(xs):]
    with spans.span(name, xs[0]):
        out = fn(*xs, T.unflatten(zip((p for p, _ in flat), ts)), *args)
    if isinstance(out, tuple):
        return (_EdgeOut.apply(edge, out[0]), *out[1:])
    return _EdgeOut.apply(edge, out)


# ---------------------------------------------------------------------------
# attention block (params + apply), GQA + optional bias + RoPE
# ---------------------------------------------------------------------------

def init_attention(init: Init, cfg, lead=()):
    d, qd, kvd = cfg.attn_in, cfg.q_dim, cfg.kv_dim
    p, s = {}, {}
    p["wq"], s["wq"] = dense_init(init, d, qd, ("embed", "q_heads"), lead)
    p["wk"], s["wk"] = dense_init(init, d, kvd, ("embed", "kv_heads"), lead)
    p["wv"], s["wv"] = dense_init(init, d, kvd, ("embed", "kv_heads"), lead)
    p["wo"], s["wo"] = dense_init(init, qd, cfg.d_model,
                                  ("q_heads", "embed"), lead)
    if cfg.qkv_bias:
        z = lambda n: init.full((*lead, n), 0.0)
        p["bq"], s["bq"] = z(qd), ("q_heads",)
        p["bk"], s["bk"] = z(kvd), ("kv_heads",)
        p["bv"], s["bv"] = z(kvd), ("kv_heads",)
    return p, s


def decode_attention(q, k, v, cur_index: int, scale=None):
    """Single-token attention, un-chunked: q [B,1,H,hd] vs cache
    [B,S,K,hd]. Scores in fp32 (divided by sqrt(hd), or times ``scale``),
    keys past ``cur_index`` masked, the probabilities cast to the cache's
    dtype before ``p @ v``, as the reference computes it."""
    B, _, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qn = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qn.to(torch.float32),
                     k.to(torch.float32))
    s = s / math.sqrt(hd) if scale is None else s * scale
    valid = (torch.arange(S, device=q.device) <= cur_index)[None, None,
                                                            None, :]
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v.dtype), v)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def project_qkv(p, x, cfg, positions):
    """x [B,S,D] -> q [B,S,H,hd], k and v [B,S,K,hd]: the projections
    (+ bias), RoPE on q and k."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(dt)).reshape(B, S, K, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, K, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt).reshape(1, 1, H, hd)
        k = k + p["bk"].to(dt).reshape(1, 1, K, hd)
        v = v + p["bv"].to(dt).reshape(1, 1, K, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def apply_attention(p, x, cfg, positions, cache=None, cache_index=None):
    """Full-sequence (``cache=None``) or single-step decode.

    cache: dict(k=[B,Smax,K,hd], v=[B,Smax,K,hd]); cache_index: the host
    int position of this step's token. The decode branch writes the step's
    k/v into ``cache`` in place and returns it. Returns (out [B,S,D], the
    {"k", "v"} attended over: the sequence's own (a prefill keeps them for
    its cache), or the cache written)."""
    B, S, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, positions)
    if cache is None:
        out = chunked_attention(q, k, v, causal=cfg.causal,
                                chunk=cfg.attn_chunk, scale=attn_scale(cfg))
        cache = {"k": k, "v": v}
    else:
        idx = int(cache_index)
        ck, cv = cache["k"], cache["v"]
        if S != 1:
            raise ValueError(f"a cached call decodes one token, got {S}")
        if not 0 <= idx < ck.shape[1]:
            # the reference's dynamic_update_slice would clamp the write
            # onto the last slot; here it is an error
            raise IndexError(f"cache index {idx} out of range for a cache "
                             f"of length {ck.shape[1]}")
        ck[:, idx:idx + 1] = k.to(ck.dtype)
        cv[:, idx:idx + 1] = v.to(cv.dtype)
        out = decode_attention(q, ck, cv, idx, attn_scale(cfg))
        cache = {"k": ck, "v": cv}
    return out.reshape(B, S, -1) @ p["wo"].to(x.dtype), cache


# ---------------------------------------------------------------------------
# MLP (swiglu / geglu / gelu)
# ---------------------------------------------------------------------------

def init_mlp(init: Init, cfg, d_ff=None, lead=()):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p, s = {}, {}
    p["wi"], s["wi"] = dense_init(init, d, f, ("embed", "mlp"), lead)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["wg"], s["wg"] = dense_init(init, d, f, ("embed", "mlp"), lead)
    p["wo"], s["wo"] = dense_init(init, f, d, ("mlp", "embed"), lead)
    return p, s


def init_adapter(init: Init, cfg, lead=()):
    """A LoRA adapter of the gated MLP's gate/up product: ``wa`` [d, r],
    then ``wg`` and ``wi`` [r, d_ff] (the gate's and the up product's
    halves)."""
    d, r, f = cfg.d_model, cfg.adapter_rank, cfg.d_ff
    p, s = {}, {}
    p["wa"], s["wa"] = dense_init(init, d, r, ("embed", None), lead)
    p["wg"], s["wg"] = dense_init(init, r, f, (None, "mlp"), lead)
    p["wi"], s["wi"] = dense_init(init, r, f, (None, "mlp"), lead)
    return p, s


def apply_mlp(p, x, cfg, adapter=None):
    """The MLP; ``adapter``: a LoRA adapter whose (x wa) wg and (x wa) wi
    add to the gate and up products."""
    dt = x.dtype
    u = None if adapter is None else x @ adapter["wa"].to(dt)

    def product(name):
        y = x @ p[name].to(dt)
        return y if u is None else y + u @ adapter[name].to(dt)
    h = product("wi")
    if cfg.mlp_kind == "swiglu":
        h = F.silu(product("wg")) * h
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(product("wg"), approximate=cfg.gelu_approx) * h
    else:
        h = F.gelu(h, approximate=cfg.gelu_approx)
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# embeddings + chunked cross-entropy
# ---------------------------------------------------------------------------

def init_embedding(init: Init, cfg):
    """Embedding rows padded to cfg.vocab_padded; padded logits are masked
    out of the loss."""
    V = cfg.vocab_padded
    p = {"tok": init.normal((V, cfg.d_model), 1.0)}
    s = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["out"] = init.normal((V, cfg.d_model), 1.0 / math.sqrt(cfg.d_model))
        s["out"] = ("vocab", "embed")
    return p, s


def embed_tokens(p, tokens, dtype):
    return F.embedding(tokens.to(torch.int64), p["tok"]).to(dtype)


def unembed_matrix(p):
    return p["out"] if "out" in p else p["tok"]


def _chunk_loss(hc, lc, mc, W, vneg):
    logits = torch.einsum("bcd,vd->bcv", hc.to(torch.float32),
                          W.to(torch.float32)) + vneg
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.to(torch.int64)[..., None])[..., 0]
    return torch.sum((lse - gold) * mc), torch.sum(mc)


def chunked_ce_loss(emb_params, hidden, labels, mask, chunk: int,
                    vocab_size: int | None = None, count=None):
    """Mean next-token CE, one sequence chunk at a time.

    hidden: [B,S,D]; labels/mask: [B,S]. Each chunk is recomputed in
    backward (``torch.utils.checkpoint``) while gradients are taken.
    Padded vocab rows (>= vocab_size) are masked out of the partition
    function. ``count``: what the summed CE is divided by (default: the
    counted tokens, at least 1).
    """
    W = unembed_matrix(emb_params)  # [Vp, D]
    B, S, D = hidden.shape
    C = min(chunk, S)
    n = S // C
    if n * C != S:
        raise ValueError("seq must divide by loss_chunk")
    Vp = W.shape[0]
    vmask = (torch.arange(Vp, device=W.device)
             < (vocab_size or Vp)).to(torch.float32)
    vneg = (1.0 - vmask) * -1e30
    maskf = mask.to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32, device=W.device)
    cnt = torch.zeros((), dtype=torch.float32, device=W.device)
    for i in range(n):
        args = (hidden[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C],
                maskf[:, i * C:(i + 1) * C], W, vneg)
        if torch.is_grad_enabled():
            l, c = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            l, c = _chunk_loss(*args)
        tot, cnt = tot + l, cnt + c
    return tot / (torch.clamp_min(cnt, 1.0) if count is None else count)


def logits_last(emb_params, hidden_last, vocab_size: int | None = None):
    """Decode-step logits for the final position. hidden_last: [B, D].
    Padded vocab rows are masked to -1e30 (the shape stays padded)."""
    W = unembed_matrix(emb_params)
    logits = torch.einsum("bd,vd->bv", hidden_last.to(torch.float32),
                          W.to(torch.float32))
    if vocab_size is not None and vocab_size < W.shape[0]:
        logits = logits + (torch.arange(W.shape[0], device=W.device)
                           >= vocab_size) * -1e30
    return logits
