"""The placement inside the model: FSDP's gathers over ``data`` and tensor
parallelism over ``model``, called by name over ``torch.distributed``.

The reference leaves both to GSPMD (its params carry ``NamedSharding``s
from the partition rules). Here every rank holds the block of each leaf
that ``launch/sharding.py`` ``place`` gives it, and the model code calls
the collectives itself:

  * FSDP: a leaf placed on ``data`` is gathered whole over ``data`` just
    before its layer uses it (``Shards.whole_over_data``; inside the
    layer's checkpointed function, so the recompute in backward gathers it
    again and no gathered layer outlives its use). The gather's backward
    is the rank's block of the mean gradient over ``data``.
  * Tensor parallelism (a ``model`` axis > 1): a block is a sum of parts,
    one per ``model`` rank. Its input enters through ``copy_to`` (the
    gradient summed over ``model`` in backward), each rank computes its
    part, and ``reduce_from`` sums the parts. A weight this rank uses only
    in part is, by its pspec: its own block (column- or row-parallel, when
    the rank's part is exactly that block), a ``gather_from`` over
    ``model`` (the gradient's block summed over ``model``), or a
    replicated leaf through ``copy_to``. The parts:
      - attention: each rank's q heads (equal blocks when H divides the
        axis, else a ragged split), their kv heads by global index
        (h // (H / K)), then its rows of ``wo``. A ``wk``/``wv`` split in
        the middle of a head (the rule tests the flattened K x hd dim)
        goes through the gathered case;
      - MLP: each rank's columns of d_ff in ``wi``/``wg``, rows of ``wo``;
      - MoE: routing and its losses on every rank; each rank runs its
        experts over all tokens (``expert`` on ``model``) or every expert
        over its d_ff columns (``mlp`` on ``model``); the shared experts
        are an MLP part; one sum;
      - embedding: a vocab-parallel lookup (zero outside the rank's rows,
        then a sum); the loss takes the log-sum-exp across shards (max,
        then a sum of exp) and the label's logit from its owner; decode
        logits are gathered whole over ``model``.
    Decode attention with a cache placed on S (``cache_pspecs`` picks the
    largest divisible of S, K and hd): the step's k/v go into the rank
    that owns slot ``index``, each rank attends over its slots with all
    heads, and the partial (max, sum, out) are combined across ``model``
    by the log-sum-exp rule. A cache placed on K or hd is gathered for the
    layer, attended whole, and the rank's block of the slot written back.

      - Mamba blocks (``mamba``; the ssm family and the hybrid's layers):
        each rank runs ``models/mamba.py`` on its block of the d_inner
        channels (every leaf on "inner" is its own block). Mamba-1: the
        input enters through ``copy_to``, ``x_proj``'s partial products
        are summed over ``model`` forward AND backward (dt_raw, B and C
        then feed only the rank's channels, so their cotangents are
        parts of one sum), ``out_proj``'s are summed. Mamba-2: B, C and
        dt come from replicated weights on every rank and enter the
        rank's channels through ``copy_to`` (so do A and D); the gated
        RMSNorm's sum of squares is summed over ``model`` both ways and
        divided by the whole d_inner; ``out_proj`` is summed. A rank's
        channels may end inside a head (``ssm_heads % model != 0``): its
        channels are then taken in pieces of gcd(head_dim, block) that
        each lie in one head, whose dt, A and D come by global head
        index. Decode and prefill states are the rank's blocks as
        ``cache_pspecs`` places them: a block that is the rank's
        channels is used as it is, any other (conv_B / conv_C on N, h on
        hd or N) is gathered whole over ``model`` for the step, and the
        rank's block of the new state is cut from the whole.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.launch.cost import unrecorded
from repro_torch.launch.mesh import (all_gather_dim, all_reduce_max_,
                                     copy_to, gather_from, reduce_from)
from . import layers as L
from . import mamba as M

_NEG = -1e30


class Shards:
    """Where the leaves of a (sub)tree lie: the mesh and their pspecs;
    ``batch_axes``: the mesh axes the batch a loss averages over is split
    on (default (pod, data); a pod's own batch under the sampled
    exchange); ``rows``: (valid, total) of that batch as this rank holds
    it — ``valid`` [b] bool marks the rank's rows that are real (the rest
    pad a short share and weigh zero), ``total`` counts the real rows over
    the batch's ranks. None: every row of every rank is real."""

    def __init__(self, mesh, specs, batch_axes=None, rows=None):
        self.mesh = mesh
        self.specs = specs
        self.m = mesh.shape.get("model", 1)
        self.r = mesh.coords.get("model", 0)
        self.batch_axes = tuple(a for a in (batch_axes or ("pod", "data"))
                                if a in mesh.axis_names)
        self.nranks = math.prod(mesh.shape[a] for a in self.batch_axes)
        self.rows = rows

    @property
    def tp(self) -> bool:
        return self.m > 1

    def _like(self, specs) -> "Shards":
        return Shards(self.mesh, specs, self.batch_axes, self.rows)

    def __getitem__(self, key) -> "Shards":
        return self._like(self.specs[key])

    def __contains__(self, key) -> bool:
        return key in self.specs

    def unstacked(self) -> "Shards":
        """The specs of one layer of stacked ``[L, ...]`` leaves."""
        return self._like(T.tree_map(lambda s: tuple(s[1:]), self.specs))

    def with_rows(self, valid, total: int) -> "Shards":
        """These shards over a batch whose rows on this rank are ``valid``
        and number ``total`` real rows over the batch's ranks."""
        return Shards(self.mesh, self.specs, self.batch_axes, (valid, total))

    def batch_rows(self, b: int, device):
        """(valid [b] bool, the real rows over the batch's ranks)."""
        if self.rows is None:
            return (torch.ones((b,), dtype=torch.bool, device=device),
                    b * self.nranks)
        return self.rows

    def model_dim(self, name: str):
        """The dim of leaf ``name`` placed on ``model``, or None."""
        spec = self.specs[name]
        return spec.index("model") if "model" in spec else None

    def batch_sum(self, t):
        """The sum of a per-rank statistic ``t`` over the batch's ranks.
        Its gradient reaches each rank's ``t`` times the number of those
        ranks, which the step's mean of the ranks' gradients divides
        back out (a mean over the ranks of ``nranks * t``, whose backward
        passes the gradient as it is)."""
        t = t * self.nranks
        for a in self.batch_axes:
            t = reduce_from(self.mesh, a, t, mean=True)
        return t

    def whole_over_data(self, tree):
        """Every leaf placed on ``data`` gathered over it (FSDP); the
        gradient's backward is the rank's block of the mean over
        ``data``."""
        def one(x, spec):
            if "data" not in spec:
                return x
            return gather_from(self.mesh, "data", x, spec.index("data"),
                               mean=True)
        return T.tree_map(one, tree, self.specs)


# ---------------------------------------------------------------------------
# the rank's part of a leaf
# ---------------------------------------------------------------------------

def ranges(n: int, m: int) -> list:
    """[lo, hi) of each of m parts of n items: equal blocks when m divides
    n, else ``numpy.array_split``'s ragged split."""
    q, rem = divmod(n, m)
    out, lo = [], 0
    for i in range(m):
        hi = lo + q + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _is_own_block(sh: Shards, name: str, w, dim: int, parts) -> bool:
    """True when every rank's part along ``dim`` is exactly its own block
    of ``w`` (the same answer on every rank)."""
    if sh.model_dim(name) != dim:
        return False
    n = w.shape[dim]
    return all(p == (i * n, (i + 1) * n) for i, p in enumerate(parts))


def take(sh: Shards, name: str, w, dim: int, parts):
    """Rank r's part ``parts[r]`` (global [lo, hi) along ``dim``) of leaf
    ``name``: its own block, else from the whole leaf gathered over
    ``model`` (a model-placed leaf) or entering through ``copy_to`` (a
    replicated one)."""
    if _is_own_block(sh, name, w, dim, parts):
        return w
    d = sh.model_dim(name)
    whole = (copy_to(sh.mesh, "model", w) if d is None
             else gather_from(sh.mesh, "model", w, d))
    lo, hi = parts[sh.r]
    return whole.narrow(dim, lo, hi - lo)


def cols(sh: Shards, name: str, x, w, parts):
    """``x @ w[:, lo:hi]`` for rank r's ``parts[r]`` of the output columns
    (the last dim): its own column block, else the products of the ranks'
    blocks gathered over ``model`` (the gradient's block summed in
    backward), else a replicated ``w`` through ``copy_to``."""
    dt = x.dtype
    if _is_own_block(sh, name, w, w.ndim - 1, parts):
        return x @ w.to(dt)
    lo, hi = parts[sh.r]
    if sh.model_dim(name) is None:
        return x @ copy_to(sh.mesh, "model", w)[..., lo:hi].to(dt)
    y = gather_from(sh.mesh, "model", x @ w.to(dt), x.ndim - 1)
    return y[..., lo:hi]


def whole_cols(sh: Shards, name: str, x, w):
    """``x @ w`` with every output column, where ``w`` may be split on its
    last dim (the ranks' products gathered)."""
    return cols(sh, name, x, w, [(0, _global(sh, name, w, w.ndim - 1))]
                * sh.m)


def _global(sh, name, w, dim) -> int:
    n = w.shape[dim]
    return n * sh.m if sh.model_dim(name) == dim else n


def block(t, dim: int, sh: Shards):
    """This rank's block of a whole tensor along ``dim`` over ``model``: a
    copy (a contiguous slice would be a view that keeps the whole
    alive)."""
    n = t.shape[dim] // sh.m
    return t.narrow(dim, sh.r * n, n).clone(
        memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _head_parts(cfg, m: int):
    """Each rank's q heads [h0, h1) and the kv heads [k0, k1) they read,
    by global index: [((h0, h1), (k0, k1))]."""
    G = cfg.num_heads // cfg.num_kv_heads
    return [((lo, hi), (lo // G, (hi - 1) // G + 1))
            for lo, hi in ranges(cfg.num_heads, m)]


def _qkv(sh, p, x, cfg, positions, qparts, kvparts):
    """This rank's q columns and the k/v columns it reads, with their
    biases and RoPE: q [B,S,Hl,hd], k/v [B,S,Kl,hd]."""
    B, S, _ = x.shape
    hd, dt = cfg.head_dim, x.dtype
    q = cols(sh, "wq", x, p["wq"], qparts)
    k = cols(sh, "wk", x, p["wk"], kvparts)
    v = cols(sh, "wv", x, p["wv"], kvparts)
    if cfg.qkv_bias:
        q = q + take(sh, "bq", p["bq"], 0, qparts).to(dt)
        k = k + take(sh, "bk", p["bk"], 0, kvparts).to(dt)
        v = v + take(sh, "bv", p["bv"], 0, kvparts).to(dt)
    q, k, v = (t.reshape(B, S, -1, hd) for t in (q, k, v))
    q = L.shard_heads(L.rope(q, positions, cfg.rope_theta),
                      cfg.constrain_acts, sh.mesh, cfg.num_heads)
    return q, L.rope(k, positions, cfg.rope_theta), v


def _kv_for_heads(k, v, cfg, q_lo: int, n_q: int, k_lo: int):
    """k/v for this rank's q heads [q_lo, q_lo + n_q): as they are when
    those heads are whole GQA groups, else one kv head per q head (the
    global mapping h // (H / K))."""
    G = cfg.num_heads // cfg.num_kv_heads
    if q_lo % G == 0 and n_q % G == 0:
        return k, v
    idx = torch.tensor([h // G - k_lo for h in range(q_lo, q_lo + n_q)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def attention(sh: Shards, p, x, cfg, positions, causal=None):
    """The full-sequence attention block (training and prefill) as a sum
    of the ranks' head parts. Returns (out [B,S,D], this rank's k and v
    for all kv heads or None) — k/v whole only when ``causal`` is given
    (prefill, no gradient), for its cache."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    x = copy_to(sh.mesh, "model", x)
    heads = _head_parts(cfg, sh.m)
    qparts = [(h0 * hd, h1 * hd) for (h0, h1), _ in heads]
    (h0, h1), (k0, k1) = heads[sh.r]
    if causal is None:
        q, k, v = _qkv(sh, p, x, cfg, positions, qparts,
                       [(a * hd, b * hd) for _, (a, b) in heads])
        whole = None
    else:          # prefill: every kv head, for the cache
        q, k, v = _qkv(sh, p, x, cfg, positions, qparts,
                       [(0, cfg.num_kv_heads * hd)] * sh.m)
        whole = (k, v)
        k, v = k[:, :, k0:k1], v[:, :, k0:k1]
    k, v = _kv_for_heads(k, v, cfg, h0, h1 - h0, k0)
    a = L.chunked_attention(q, k, v, causal=cfg.causal if causal is None
                            else causal, chunk=cfg.attn_chunk)
    wo = take(sh, "wo", p["wo"], 0, qparts)
    out = a.reshape(B, S, -1) @ wo.to(x.dtype)
    return reduce_from(sh.mesh, "model", out), whole


def _lse_combine(sh, m, l, o):
    """Softmax partials of the ranks' slots -> the whole attention: m, l
    [B,K,G] (max and sum of exp(s - m)), o [B,K,G,hd] (sum of
    exp(s - m) v); ranks with no valid slot hold m = -1e30."""
    ms = all_gather_dim(sh.mesh, "model", m[None], 0)
    ls = all_gather_dim(sh.mesh, "model", l[None], 0)
    os_ = all_gather_dim(sh.mesh, "model", o[None], 0)
    top = ms.amax(dim=0)
    c = torch.exp(ms - top)
    return ((c[..., None] * os_).sum(0)
            / torch.clamp_min((c * ls).sum(0), 1e-30)[..., None])


def decode_attention(sh: Shards, p, x, cfg, positions, ck, cv, index: int,
                     cache_dim):
    """One decode step of the attention block against this rank's block
    of the layer's cache ck/cv (placed on per-layer dim ``cache_dim``: 1
    for S, 2 for K, 3 for hd, None whole), written in place. All heads on
    every rank; then each rank's rows of ``wo`` and one sum."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = whole_cols(sh, "wq", x, p["wq"])
    k = whole_cols(sh, "wk", x, p["wk"])
    v = whole_cols(sh, "wv", x, p["wv"])
    if cfg.qkv_bias:
        whole = lambda n, b: take(sh, n, b, 0, [(0, _global(sh, n, b, 0))]
                                  * sh.m)
        q = q + whole("bq", p["bq"]).to(dt)
        k = k + whole("bk", p["bk"]).to(dt)
        v = v + whole("bv", p["bv"]).to(dt)
    q = L.rope(q.reshape(B, 1, H, hd), positions, cfg.rope_theta)
    k = L.rope(k.reshape(B, 1, K, hd), positions, cfg.rope_theta)
    v = v.reshape(B, 1, K, hd)
    if cache_dim == 1:
        a = _seq_parallel_decode(sh, q, k, v, ck, cv, index)
    else:
        kw, vw = ck, cv
        if cache_dim is not None:
            kw = all_gather_dim(sh.mesh, "model", ck, cache_dim)
            vw = all_gather_dim(sh.mesh, "model", cv, cache_dim)
        kw[:, index:index + 1] = k.to(kw.dtype)
        vw[:, index:index + 1] = v.to(vw.dtype)
        a = L.decode_attention(q, kw, vw, index)
        if cache_dim is not None:
            n = ck.shape[cache_dim]
            lo = sh.r * n
            ck[:, index] = kw[:, index].narrow(cache_dim - 1, lo, n)
            cv[:, index] = vw[:, index].narrow(cache_dim - 1, lo, n)
    parts = ranges(H * hd, sh.m)
    lo, hi = parts[sh.r]
    wo = take(sh, "wo", p["wo"], 0, parts)
    out = a.reshape(B, 1, -1)[..., lo:hi] @ wo.to(dt)
    return reduce_from(sh.mesh, "model", out)


def _seq_parallel_decode(sh, q, k, v, ck, cv, index: int):
    """Attention of one token over a cache split on S: rank r holds slots
    [r Sl, (r + 1) Sl). The owner of ``index`` writes k/v; each rank
    attends over its valid slots; the partials combine by log-sum-exp.
    Scores and partials in fp32; p cast to the cache's dtype before p @ v,
    as the reference's ``decode_attention``."""
    B, _, H, hd = q.shape
    Sl, K = ck.shape[1], ck.shape[2]
    G = H // K
    lo = sh.r * Sl
    if lo <= index < lo + Sl:
        ck[:, index - lo:index - lo + 1] = k.to(ck.dtype)
        cv[:, index - lo:index - lo + 1] = v.to(cv.dtype)
    qn = q.reshape(B, K, G, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qn, ck.to(torch.float32)) \
        / math.sqrt(hd)
    valid = (torch.arange(lo, lo + Sl, device=q.device) <= index)
    s = torch.where(valid[None, None, None, :], s, _NEG)
    m = s.amax(dim=-1)
    e = torch.where(valid[None, None, None, :], torch.exp(s - m[..., None]),
                    0.0)
    l = e.sum(dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", e.to(cv.dtype), cv).to(torch.float32)
    out = _lse_combine(sh, m, l, o)
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_part(sh: Shards, p, x, cfg):
    """This rank's part of the MLP (its d_ff columns of ``wi``/``wg`` and
    rows of ``wo``); ``x`` has entered through ``copy_to``."""
    n = _global(sh, "wi", p["wi"], p["wi"].ndim - 1)
    parts = ranges(n, sh.m)
    h = cols(sh, "wi", x, p["wi"], parts)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(cols(sh, "wg", x, p["wg"], parts)) * h
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(cols(sh, "wg", x, p["wg"], parts),
                   approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ take(sh, "wo", p["wo"], 0, parts).to(x.dtype)


def mlp(sh: Shards, p, x, cfg):
    """The MLP block as the sum of the ranks' parts."""
    return reduce_from(sh.mesh, "model",
                       mlp_part(sh, p, copy_to(sh.mesh, "model", x), cfg))


# ---------------------------------------------------------------------------
# embedding, loss and logits
# ---------------------------------------------------------------------------

def _unembed_name(sh) -> str:
    return "out" if "out" in sh else "tok"


def embed_tokens(sh: Shards, p, tokens, dtype):
    """The vocab-parallel lookup: each rank's rows, zero for tokens outside
    them, summed over ``model`` (replicated: the plain lookup)."""
    W = p["tok"]
    if sh.model_dim("tok") is None:
        return L.embed_tokens(p, tokens, dtype)
    lo = sh.r * W.shape[0]
    t = tokens.to(torch.int64)
    mine = (t >= lo) & (t < lo + W.shape[0])
    e = F.embedding(torch.where(mine, t - lo, 0), W) * mine[..., None]
    return reduce_from(sh.mesh, "model", e).to(dtype)


def _chunk_loss_tp(sh, hc, lc, mc, W, vneg, lo):
    logits = torch.einsum("bcd,vd->bcv", hc.to(torch.float32),
                          W.to(torch.float32)) + vneg
    top = all_reduce_max_(sh.mesh, "model",
                          logits.detach().amax(dim=-1).contiguous())
    se = reduce_from(sh.mesh, "model",
                     torch.exp(logits - top[..., None]).sum(dim=-1))
    lse = top + torch.log(se)
    lab = lc.to(torch.int64)
    mine = (lab >= lo) & (lab < lo + W.shape[0])
    gold = torch.gather(logits, -1, torch.where(mine, lab - lo, 0)[..., None]
                        )[..., 0] * mine
    gold = reduce_from(sh.mesh, "model", gold)
    return torch.sum((lse - gold) * mc), torch.sum(mc)


def chunked_ce_loss(sh: Shards, emb_params, hidden, labels, mask,
                    chunk: int, vocab_size=None, count=None):
    """``layers.chunked_ce_loss`` over a vocab split on ``model``: each
    rank's logits, the log-sum-exp across shards and the label's logit
    from its owner (a replicated vocab: the plain loss)."""
    name = _unembed_name(sh)
    if sh.model_dim(name) is None:
        return L.chunked_ce_loss(emb_params, hidden, labels, mask, chunk,
                                 vocab_size=vocab_size, count=count)
    W = emb_params[name]
    lo = sh.r * W.shape[0]
    B, S, D = hidden.shape
    C = min(chunk, S)
    n = S // C
    if n * C != S:
        raise ValueError("seq must divide by loss_chunk")
    Vp = W.shape[0] * sh.m
    vidx = torch.arange(lo, lo + W.shape[0], device=W.device)
    vneg = (vidx >= (vocab_size or Vp)).to(torch.float32) * _NEG
    maskf = mask.to(torch.float32)
    hidden = copy_to(sh.mesh, "model", hidden)
    tot = torch.zeros((), dtype=torch.float32, device=W.device)
    cnt = torch.zeros((), dtype=torch.float32, device=W.device)
    for i in range(n):
        args = (sh, hidden[:, i * C:(i + 1) * C],
                labels[:, i * C:(i + 1) * C], maskf[:, i * C:(i + 1) * C],
                W, vneg, lo)
        if torch.is_grad_enabled():
            l, c = torch.utils.checkpoint.checkpoint(
                _chunk_loss_tp, *args, use_reentrant=False)
        else:
            l, c = _chunk_loss_tp(*args)
        tot, cnt = tot + l, cnt + c
    return tot / (torch.clamp_min(cnt, 1.0) if count is None else count)


def logits_last(sh: Shards, emb_params, hidden_last, vocab_size=None):
    """``layers.logits_last`` with a vocab split on ``model``: each rank's
    logits, gathered whole (padded rows masked by their global index)."""
    name = _unembed_name(sh)
    if sh.model_dim(name) is None:
        return L.logits_last(emb_params, hidden_last, vocab_size)
    W = emb_params[name]
    lo = sh.r * W.shape[0]
    logits = torch.einsum("bd,vd->bv", hidden_last.to(torch.float32),
                          W.to(torch.float32))
    if vocab_size is not None and vocab_size < W.shape[0] * sh.m:
        logits = logits + (torch.arange(lo, lo + W.shape[0],
                                        device=W.device)
                           >= vocab_size) * _NEG
    return all_gather_dim(sh.mesh, "model", logits, 1)


# ---------------------------------------------------------------------------
# Mamba blocks: tensor parallelism over the d_inner channels
# ---------------------------------------------------------------------------

class _Channels:
    """``models/mamba.py``'s ``part``: rank r's block [lo, hi) of the
    d_inner channels (each leaf on "inner" placed on ``model``)."""

    def __init__(self, sh: Shards, cfg):
        self.mesh = sh.mesh
        self.lo, self.hi = ranges(cfg.d_inner, sh.m)[sh.r]
        if cfg.ssm_kind == "mamba2":
            self.width = math.gcd(cfg.ssm_head_dim, self.hi - self.lo,
                                  self.lo)

    def enter(self, x):
        return copy_to(self.mesh, "model", x)

    shared = enter

    def sum(self, t):
        """Partial products summed over ``model``, whose cotangent is in
        turn a part of one sum: all-reduced both ways."""
        return copy_to(self.mesh, "model", reduce_from(self.mesh, "model", t))

    def out(self, t):
        return reduce_from(self.mesh, "model", t)

    def heads(self, cfg, device):
        """The global head of each ``width``-channel piece of the block."""
        return torch.arange(self.lo, self.hi, self.width,
                            device=device) // cfg.ssm_head_dim


def _channel_view(name: str, t, cfg):
    """A per-layer state leaf as (view with the channels on one dim, that
    dim), or (t, None) for a state of replicated values (conv_B,
    conv_C)."""
    if name in ("conv", "conv_x"):                 # [B, K-1, d_inner]
        return t, 2
    if name != "h":
        return t, None
    if cfg.ssm_kind == "mamba1":                   # [B, d_inner, N]
        return t, 1
    return t.reshape(t.shape[0], -1, t.shape[-1]), 1   # [B, H*hd, N]


def _is_channel_block(name: str, dim, cfg) -> bool:
    """True when a leaf's block on ``model`` (per-layer dim ``dim``) is
    the rank's channels: the channel dim (d_inner, or Mamba-2's heads)."""
    if name in ("conv", "conv_x"):
        return dim == 2
    return name == "h" and dim == 1


def _state_part(sh, name, t, dim, cfg, part):
    """The state this rank's block step reads: its channels (a Mamba-2 h
    as [B, heads, width, N]), or the whole leaf (conv_B / conv_C, or
    every leaf when the channels are not placed: ``part`` None). ``t``:
    the rank's block, placed on per-layer dim ``dim`` (or None)."""
    if part is not None and _is_channel_block(name, dim, cfg):
        view = t
    else:
        whole = t if dim is None else all_gather_dim(
            sh.mesh, "model", t.contiguous(), dim)
        view, cd = _channel_view(name, whole, cfg)
        if part is None or cd is None:
            return whole
        view = view.narrow(cd, part.lo, part.hi - part.lo)
    if name == "h" and cfg.ssm_kind == "mamba2":
        return view.reshape(view.shape[0], -1, part.width, view.shape[-1])
    return view


def _state_block(sh, name, new, dim, cfg, part, whole_shape):
    """The rank's block on per-layer dim ``dim`` of a new state from its
    step's part ``new`` (as ``_state_part`` gave it): the channels
    gathered whole over ``model`` unless they are the block."""
    if part is not None and _is_channel_block(name, dim, cfg):
        return new
    cd = _channel_view(name, new, cfg)[1]
    if part is not None and cd is not None:
        if name == "h" and cfg.ssm_kind == "mamba2":
            new = new.reshape(new.shape[0], -1, new.shape[-1])
        new = all_gather_dim(sh.mesh, "model", new.contiguous(), cd)
    whole = new.reshape(whole_shape)
    return whole if dim is None else block(whole, dim, sh)


def mamba(sh: Shards, p, x, cfg, state=None, return_state=False,
          dims=None):
    """The Mamba block (``mamba.apply_mamba1`` / ``apply_mamba2``) as a sum
    of the ranks' channel blocks. ``state``: this rank's blocks of the
    layer's decode state, placed on per-layer dims ``dims`` ({leaf: dim
    or None}, as ``cache_pspecs`` places them); the new state (decode, or
    prefill with ``return_state``) comes back the same way. When d_inner
    does not divide over ``model`` its leaves stay whole and every rank
    runs the one-process block."""
    m1 = cfg.ssm_kind == "mamba1"
    apply = M.apply_mamba1 if m1 else M.apply_mamba2
    dims = dims or {}
    part = _Channels(sh, cfg) if sh.model_dim("wx") is not None else None
    if state is not None:
        state = {k: _state_part(sh, k, t, dims.get(k), cfg, part)
                 for k, t in state.items()}
    y, new = apply(p, x, cfg, state, return_state, part)
    if new is not None:
        with unrecorded():     # the states' whole per-layer shapes
            whole = {k: t.shape for k, t in (
                M.mamba1_state if m1 else M.mamba2_state)(
                    cfg, x.shape[0], device="meta").items()}
        new = {k: _state_block(sh, k, t, dims.get(k), cfg, part, whole[k])
               for k, t in new.items()}
    return y, new
