"""Selective state-space blocks: Mamba-1 (S6) and Mamba-2 (SSD).

Port of ``repro/models/mamba.py``. The sequence is scanned in chunks that
carry the SSM state, as the reference's ``lax.scan`` does: ``nC =
max(S // ssm_chunk, 1)`` chunks of ``Ck = S // nC`` tokens, and a length
that does not split so raises ``ValueError``. Within a chunk:

  * Mamba-1 solves h_t = a_t h_{t-1} + bx_t with a log-depth doubling scan
    over the chunk axis in fp32 (``_m1_scan_chunk``: ceil(log2 Ck)
    out-of-place steps). The reference's ``lax.associative_scan``
    associates in another order, so the two agree to a tolerance. The
    closed form exp(cumsum(dt A)) is not used: Mamba-1's A = -[1..N] and
    dt up to 0.1 put the cumulative log-decay near -400 inside a 256-step
    chunk, and its reciprocal overflows fp32;
  * Mamba-2 takes the quadratic SSD dual form, the reference's einsums.
    Its intra-chunk decay exp(cum_t - cum_s) is masked to the causal
    triangle BEFORE the exp (the reference masks after it): the values
    are the same, but above the diagonal the reference's exp can
    overflow to inf, and inf x a zero cotangent makes its gradient NaN.

Each chunk's body is recomputed in backward (``torch.utils.checkpoint``)
while gradients are taken, as the reference's ``jax.checkpoint``.

The depthwise causal conv is ``F.conv1d(groups=C)`` on the fp32
left-padded input, the bias added after, cast back to the activation
dtype (XLA's ``conv_general_dilated`` with ``feature_group_count = C``).
Projections run in the activation dtype; dt, A, h and the scans in fp32.

Decode carries an explicit recurrent state per layer: conv ring buffers
(``[B, K-1, C]``, the cache's dtype) and h (fp32). A prefill of fewer than
K-1 tokens raises: its conv state would be short (the reference returns
it short, and its first decode step then fails on a shape mismatch).

Input projections are stored unfused (z / x / B / C / dt), each output dim
on the "inner" logical axis where it is d_inner wide, as the reference's.

Tensor parallelism over "inner" (``models/parallel.py`` ``mamba``) runs
these same functions on a rank's block of the d_inner channels, through
``part``: an object whose hooks mark where the block meets the other
ranks (``enter``: the input every rank reads; ``shared``: values every
rank computes whole and then uses for its channels only; ``sum``: a
partial product summed over the ranks; ``out``: the block's output
summed) and which heads a rank's channels belong to (``heads``). Without
``part`` (one process, or ``model`` 1) nothing changes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import Init, dense_init

_F32 = torch.float32


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _causal_conv(x, weight, bias):
    """Depthwise causal conv over seq. x: [B,S,C]; weight: [C,K]; bias: [C]."""
    C, K = weight.shape
    xp = F.pad(x.to(_F32).transpose(1, 2), (K - 1, 0))          # [B,C,S+K-1]
    out = F.conv1d(xp, weight.to(_F32)[:, None, :], groups=C)    # [B,C,S]
    return (out.transpose(1, 2) + bias).to(x.dtype)


def _conv_step(state, xt, weight, bias):
    """One decode step of the causal conv. state: [B,K-1,C]; xt: [B,C]."""
    window = torch.cat([state, xt[:, None, :]], dim=1)
    out = torch.einsum("bkc,ck->bc", window.to(_F32),
                       weight.to(_F32)) + bias
    return window[:, 1:], out.to(xt.dtype)


def _chunk_plan(S: int, chunk: int):
    """(nC, Ck): the reference's chunking of a length-S scan."""
    nC = max(S // chunk, 1)
    Ck = S // nC
    if nC * Ck != S:
        raise ValueError(
            f"sequence length {S} does not split into nC = max(S // "
            f"ssm_chunk, 1) = {nC} chunks of S // nC = {Ck} tokens "
            f"(ssm_chunk {chunk}): the scan needs nC * Ck == S")
    return nC, Ck


def _chunks(t, nC, Ck):
    """[B, S, ...] -> [nC, B, Ck, ...] (a view)."""
    B = t.shape[0]
    return t.reshape(B, nC, Ck, *t.shape[2:]).movedim(1, 0)


def _conv_tail(t, K: int):
    """The last K-1 rows of t [B,S,C]: the conv state after a prefill, a
    copy (a view would keep all S rows of t alive with the state)."""
    if t.shape[1] < K - 1:
        raise ValueError(
            f"a prefill of {t.shape[1]} tokens leaves a conv state shorter "
            f"than ssm_conv - 1 = {K - 1} rows: prompts need at least "
            f"{K - 1} tokens")
    return t[:, t.shape[1] - (K - 1):].clone(
        memory_format=torch.contiguous_format)


def _scan_chunks(body, h, xs, nC: int, Ck: int, extra=()):
    """Run ``body(h, *chunk, *extra) -> (h, y)`` over the chunks of the
    tensors ``xs``, each chunk recomputed in backward while grad is
    enabled. Returns (final h, the ys concatenated on the sequence axis)."""
    ys = []
    for parts in zip(*(_chunks(t, nC, Ck) for t in xs)):
        if torch.is_grad_enabled():
            h, y = checkpoint(body, h, *parts, *extra, use_reentrant=False)
        else:
            h, y = body(h, *parts, *extra)
        ys.append(y)
    return h, torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# Mamba-1 (S6): per-channel diagonal A [d_inner, N]
# ---------------------------------------------------------------------------

def init_mamba1(init: Init, cfg, lead=()):
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    R = max(d // 16, 1)  # dt_rank
    p, s = {}, {}
    p["wz"], s["wz"] = dense_init(init, d, di, ("embed", "inner"), lead)
    p["wx"], s["wx"] = dense_init(init, d, di, ("embed", "inner"), lead)
    p["conv_w"] = init.gaussian((*lead, di, K), 0.1)
    s["conv_w"] = ("inner", None)
    p["conv_b"] = init.full((*lead, di), 0.0); s["conv_b"] = ("inner",)
    p["x_proj"], s["x_proj"] = dense_init(init, di, R + 2 * N,
                                          ("inner", None), lead)
    p["dt_proj"], s["dt_proj"] = dense_init(init, R, di, (None, "inner"),
                                            lead)
    u = init.uniform((*lead, di), math.log(1e-3), math.log(1e-1))
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(u)))
    s["dt_bias"] = ("inner",)
    p["A_log"] = torch.log(torch.arange(
        1, N + 1, dtype=_F32, device=init.device).expand(
            *lead, di, N).contiguous())
    s["A_log"] = ("inner", None)
    p["D"] = init.full((*lead, di), 1.0); s["D"] = ("inner",)
    p["out_proj"], s["out_proj"] = dense_init(init, di, d,
                                              ("inner", "embed"), lead)
    return p, s


def _m1_scan_chunk(h0, a, bx):
    """h_t = a_t h_{t-1} + bx_t by a doubling scan over the chunk axis.

    a, bx: [B, C, di, N] fp32; h0: [B, di, N]. After the step of stride s,
    position t holds the composition of steps (t - 2s, t]: (a, bx) <- (a_t
    a_{t-s}, a_t bx_{t-s} + bx_t), both from the old values. Out of place:
    each step's old tensors are freed as the names move on. Returns
    (h_all, h_last)."""
    C = a.shape[1]
    s = 1
    while s < C:
        tail = a[:, s:] * bx[:, :-s]
        tail += bx[:, s:]
        bx = torch.cat([bx[:, :s], tail], dim=1)
        del tail
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    h_all = a * h0[:, None]
    del a
    h_all += bx
    return h_all, h_all[:, -1]


def _m1_chunk(h, xc_, dt_c, B_c, C_c, A):
    # a, bx [B,Ck,di,N] go straight into the scan, which frees them
    h_all, h_last = _m1_scan_chunk(
        h, torch.exp(dt_c[..., None] * A),
        (dt_c * xc_.to(_F32))[..., None] * B_c.to(_F32)[:, :, None, :])
    y = torch.einsum("bcdn,bcn->bcd", h_all, C_c.to(_F32))
    return h_last.clone(), y          # a copy: the view would hold h_all


def apply_mamba1(p, x, cfg, state=None, return_state=False, part=None):
    """Full-seq (state=None) or single-step decode (state given).

    state: dict(conv=[B,K-1,di], h=[B,di,N]). Returns (y, new_state).
    return_state: full-seq prefill — also return the final recurrent state.
    part: a rank's block of the channels (``p`` and ``state`` hold its
    channels; see the module's docstring).
    """
    B, S, D = x.shape
    N = cfg.ssm_state
    di = p["A_log"].shape[0]             # d_inner, or a rank's block of it
    R = max(D // 16, 1)
    dt_ = x.dtype
    x_in = x if part is None else part.enter(x)
    z = x_in @ p["wz"].to(dt_)
    xs = x_in @ p["wx"].to(dt_)
    A = -torch.exp(p["A_log"])                                   # [di,N]

    if state is None:
        nC, Ck = _chunk_plan(S, cfg.ssm_chunk)
        xc = F.silu(_causal_conv(xs, p["conv_w"], p["conv_b"]))
        proj = xc @ p["x_proj"].to(dt_)
        if part is not None:              # x_proj contracts over inner
            proj = part.sum(proj)
        dt_raw, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
        dt = F.softplus(dt_raw.to(_F32) @ p["dt_proj"]
                        + p["dt_bias"])                          # [B,S,di]
        h0 = torch.zeros((B, di, N), dtype=_F32, device=x.device)
        h_fin, y = _scan_chunks(_m1_chunk, h0, (xc, dt, Bc, Cc), nC, Ck,
                                (A,))
        y = (y + xc.to(_F32) * p["D"]).to(dt_)
        new_state = None
        if return_state:
            new_state = {"conv": _conv_tail(xs, cfg.ssm_conv).to(dt_),
                         "h": h_fin}
    else:
        xt = xs[:, 0]                                            # [B,di]
        conv_state, xc = _conv_step(state["conv"], xt, p["conv_w"],
                                    p["conv_b"])
        xc = F.silu(xc)
        proj = xc @ p["x_proj"].to(dt_)
        if part is not None:
            proj = part.sum(proj)
        dt_raw, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
        dt = F.softplus(dt_raw.to(_F32) @ p["dt_proj"]
                        + p["dt_bias"])                          # [B,di]
        a = torch.exp(dt[..., None] * A)                         # [B,di,N]
        bx = (dt * xc.to(_F32))[..., None] * Bc.to(_F32)[:, None, :]
        h = a * state["h"] + bx
        y = torch.einsum("bdn,bn->bd", h, Cc.to(_F32))
        y = (y + xc.to(_F32) * p["D"]).to(dt_)[:, None]
        new_state = {"conv": conv_state, "h": h}

    y = y * F.silu(z if state is None else z[:, :1])
    out = y @ p["out_proj"].to(dt_)
    return (out if part is None else part.out(out)), new_state


def mamba1_state(cfg, batch: int, dtype=_F32, device=None):
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                             dtype=_F32, device=device)}


# ---------------------------------------------------------------------------
# Mamba-2 (SSD): scalar A per head, chunked dual form
# ---------------------------------------------------------------------------

def init_mamba2(init: Init, cfg, lead=()):
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, K = cfg.ssm_heads, cfg.ssm_conv
    p, s = {}, {}
    p["wz"], s["wz"] = dense_init(init, d, di, ("embed", "inner"), lead)
    p["wx"], s["wx"] = dense_init(init, d, di, ("embed", "inner"), lead)
    p["wB"], s["wB"] = dense_init(init, d, N, ("embed", None), lead)
    p["wC"], s["wC"] = dense_init(init, d, N, ("embed", None), lead)
    p["wdt"], s["wdt"] = dense_init(init, d, H, ("embed", None), lead)
    p["conv_x"] = init.gaussian((*lead, di, K), 0.1)
    s["conv_x"] = ("inner", None)
    p["conv_xb"] = init.full((*lead, di), 0.0); s["conv_xb"] = ("inner",)
    p["conv_B"] = init.gaussian((*lead, N, K), 0.1)
    s["conv_B"] = (None, None)
    p["conv_Bb"] = init.full((*lead, N), 0.0); s["conv_Bb"] = (None,)
    p["conv_C"] = init.gaussian((*lead, N, K), 0.1)
    s["conv_C"] = (None, None)
    p["conv_Cb"] = init.full((*lead, N), 0.0); s["conv_Cb"] = (None,)
    p["A_log"] = torch.log(init.uniform((*lead, H), 1.0, 16.0))
    s["A_log"] = (None,)
    u = init.uniform((*lead, H), math.log(1e-3), math.log(1e-1))
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(u)))
    s["dt_bias"] = (None,)
    p["D"] = init.full((*lead, H), 1.0); s["D"] = (None,)
    p["norm_scale"] = init.full((*lead, di), 1.0)
    s["norm_scale"] = ("inner",)
    p["out_proj"], s["out_proj"] = dense_init(init, di, d,
                                              ("inner", "embed"), lead)
    return p, s


def _m2_gated_out(p, y, z, cfg, dt_, part=None):
    y = y * F.silu(z.to(_F32))
    if part is None:
        var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    else:                 # the mean over all of d_inner: the ranks' sums
        var = part.sum(torch.sum(torch.square(y), dim=-1, keepdim=True)
                       ) / cfg.d_inner
    y = y * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"]
    out = y.to(dt_) @ p["out_proj"].to(dt_)
    return out if part is None else part.out(out)


def _m2_chunk(h, xc, Bk, Ckk, dtc, la):
    """One SSD chunk: (h_out [B,H,hd,N], y [B,C,H,hd])."""
    cum = torch.cumsum(la, dim=1)                                # [B,C,H]
    Bf, Cf = Bk.to(_F32), Ckk.to(_F32)
    xf = xc.to(_F32)
    sc = torch.einsum("btn,bsn->bts", Cf, Bf)                    # [B,C,C]
    dec = cum[:, :, None, :] - cum[:, None, :, :]                # [B,t,s,H]
    t_ = torch.arange(xc.shape[1], device=xc.device)
    causal = (t_[:, None] >= t_[None, :])[None, :, :, None]
    G = torch.exp(torch.where(causal, dec, -math.inf)) * sc[..., None]
    G = G * dtc[:, None, :, :]                                   # dt_s weight
    y = torch.einsum("btsh,bshd->bthd", G, xf)                   # intra
    y = y + torch.einsum("bth,btn,bhdn->bthd", torch.exp(cum), Cf, h)
    w = torch.exp(cum[:, -1:, :] - cum) * dtc                    # [B,C,H]
    hb = torch.einsum("bsh,bshd,bsn->bhdn", w, xf, Bf)
    h_out = torch.exp(cum[:, -1])[:, :, None, None] * h + hb
    return h_out, y


def _m2_heads(part, cfg, Bc, Cc, dt, A, D):
    """(heads, head width, B, C, dt, A, D) of the channels this block
    holds: every head, or a rank's (``part``), whose shared values enter
    through ``part.shared`` and whose per-head values are taken by global
    head index."""
    if part is None:
        return cfg.ssm_heads, cfg.ssm_head_dim, Bc, Cc, dt, A, D
    Bc, Cc, dt, A, D = (part.shared(t) for t in (Bc, Cc, dt, A, D))
    idx = part.heads(cfg, dt.device)
    return (idx.shape[0], part.width, Bc, Cc, dt.index_select(-1, idx),
            A.index_select(0, idx), D.index_select(0, idx))


def apply_mamba2(p, x, cfg, state=None, return_state=False, part=None):
    """SSD block. state: dict(conv_x, conv_B, conv_C, h=[B,H,hd,N]).
    part: a rank's block of the channels (``p``'s inner leaves and
    state's conv_x / h hold its channels, h as [B, heads, width, N] of
    ``part.heads``; see the module's docstring)."""
    B, S, D = x.shape
    N = cfg.ssm_state
    dt_ = x.dtype
    x_in = x if part is None else part.enter(x)
    z = x_in @ p["wz"].to(dt_)
    xs = x_in @ p["wx"].to(dt_)
    Bp = x @ p["wB"].to(dt_)
    Cp = x @ p["wC"].to(dt_)
    dt_raw = x @ p["wdt"].to(dt_)
    A = -torch.exp(p["A_log"])                                   # [H]

    if state is None:
        nC, Ck = _chunk_plan(S, cfg.ssm_chunk)
        xc = F.silu(_causal_conv(xs, p["conv_x"], p["conv_xb"]))
        Bc = F.silu(_causal_conv(Bp, p["conv_B"], p["conv_Bb"]))
        Cc = F.silu(_causal_conv(Cp, p["conv_C"], p["conv_Cb"]))
        dt = F.softplus(dt_raw.to(_F32) + p["dt_bias"])          # [B,S,H]
        H, hd, Bc, Cc, dt, A, Dh = _m2_heads(part, cfg, Bc, Cc, dt, A,
                                             p["D"])
        xh = xc.reshape(B, S, H, hd)
        loga = dt * A                                            # [B,S,H] (<0)
        h0 = torch.zeros((B, H, hd, N), dtype=_F32, device=x.device)
        h_fin, y = _scan_chunks(_m2_chunk, h0, (xh, Bc, Cc, dt, loga),
                                nC, Ck)
        y = y + xh.to(_F32) * Dh[None, None, :, None]
        y = y.reshape(B, S, H * hd)
        new_state = None
        if return_state:
            Kc = cfg.ssm_conv
            new_state = {"conv_x": _conv_tail(xs, Kc).to(dt_),
                         "conv_B": _conv_tail(Bp, Kc).to(dt_),
                         "conv_C": _conv_tail(Cp, Kc).to(dt_),
                         "h": h_fin}
        return _m2_gated_out(p, y, z, cfg, dt_, part), new_state

    # ---- decode step ----
    cs_x, xc = _conv_step(state["conv_x"], xs[:, 0], p["conv_x"],
                          p["conv_xb"])
    cs_B, Bc = _conv_step(state["conv_B"], Bp[:, 0], p["conv_B"],
                          p["conv_Bb"])
    cs_C, Cc = _conv_step(state["conv_C"], Cp[:, 0], p["conv_C"],
                          p["conv_Cb"])
    xc, Bc, Cc = F.silu(xc), F.silu(Bc), F.silu(Cc)
    dt = F.softplus(dt_raw[:, 0].to(_F32) + p["dt_bias"])        # [B,H]
    H, hd, Bc, Cc, dt, A, Dh = _m2_heads(part, cfg, Bc, Cc, dt, A, p["D"])
    xh = xc.reshape(B, H, hd)
    a = torch.exp(dt * A)                                        # [B,H]
    hb = torch.einsum("bh,bhd,bn->bhdn", dt, xh.to(_F32), Bc.to(_F32))
    h = a[:, :, None, None] * state["h"] + hb
    y = torch.einsum("bn,bhdn->bhd", Cc.to(_F32), h)
    y = y + xh.to(_F32) * Dh[None, :, None]
    y = y.reshape(B, 1, H * hd)
    new_state = {"conv_x": cs_x, "conv_B": cs_B, "conv_C": cs_C, "h": h}
    return _m2_gated_out(p, y, z[:, :1], cfg, dt_, part), new_state


def mamba2_state(cfg, batch: int, dtype=_F32, device=None):
    K = cfg.ssm_conv
    conv = lambda c: torch.zeros((batch, K - 1, c), dtype=dtype,
                                 device=device)
    return {"conv_x": conv(cfg.d_inner), "conv_B": conv(cfg.ssm_state),
            "conv_C": conv(cfg.ssm_state),
            "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=_F32, device=device)}
