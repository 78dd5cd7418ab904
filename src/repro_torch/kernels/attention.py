"""K7: attention, forward and backward, as fused kernels on the card.

Replaces no TPU kernel: the reference's attention (``repro/models/layers.py``
``_make_flash``) is plain JAX, chunked online softmax under a custom_vjp
that saves (out, lse) and recomputes the score tiles in backward. The
port's copy of that loop is this module's plain version
(``attention_forward_plain`` / ``attention_backward_plain``): CPU and meta
tensors take it. CUDA tensors launch ``csrc/attention.cu`` (or raise): a forward
kernel, and a backward of three (delta = rowsum(dO O), dK/dV over kv
tiles, dQ over q tiles), with the reference's arithmetic and only the
order of fp32 sums changed; the kernel's note says how.

The kernel takes bf16 q/k/v with head dims up to 256, zero-padded to 64,
128 or 256 (exact: a zero column adds nothing to any product), any GQA
group, causal or not, ``q_offset``, ``kv_valid_len`` and any Sq, Sk. Its
lse is [B, K, Sq * G] fp32, rows in (position, group head) order, read
only by its backward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels._util import (kernel_lib, raise_on_error,
                                       stream_ptr)
from repro_torch.telemetry import spans

_NEG = -1e30
HEAD_DIMS = (64, 128, 256)


# ---------------------------------------------------------------------------
# plain version: the chunked online-softmax loop
# ---------------------------------------------------------------------------

def _chunk_positions(Sq, Sk, Cq, Ck, q_offset, kv_valid_len):
    """Per q chunk and kv chunk the positions (host lists), with -1 for
    kv positions past ``kv_valid_len``."""
    qpos = [list(range(q_offset + i * Cq, q_offset + (i + 1) * Cq))
            for i in range(Sq // Cq)]
    kpos = [[p if kv_valid_len is None or p < kv_valid_len else -1
             for p in range(j * Ck, (j + 1) * Ck)] for j in range(Sk // Ck)]
    return qpos, kpos


def _visible(qp, kp, causal: bool) -> bool:
    """False when every score of the (q chunk, kv chunk) tile is masked:
    such a tile adds exactly nothing (p = 0, correction 1), so skipping it
    leaves every bit of the result as it is."""
    valid = [p for p in kp if p >= 0]
    if not valid:
        return False
    return not causal or min(valid) <= max(qp)


def _mask(qp, kp, causal: bool, device):
    """The tile's [1, Cq, 1, 1, Ck] mask, made on the device from the
    chunks' first positions (a host list copied over would stall the
    stream at every tile)."""
    q = torch.arange(qp[0], qp[0] + len(qp), device=device)
    k = torch.arange(kp[0], kp[0] + len(kp), device=device)
    nvalid = sum(p >= 0 for p in kp)
    if nvalid < len(kp):                 # positions past kv_valid_len
        k = torch.where(k < kp[0] + nvalid, k, -1)
    if causal:
        m = (q[:, None] >= k[None, :]) & (k >= 0)[None, :]
    else:
        m = ((k >= 0)[None, :]).expand(q.shape[0], k.shape[0])
    return m[None, :, None, None, :]


def attention_forward_plain(q, k, v, causal: bool, Cq: int, Ck: int,
                            q_offset: int, kv_valid_len):
    """The plain loop over (Cq, Ck) chunks, on any device -> (out [B, Sq,
    H, hd] in q's dtype, lse [B, nq, Cq, K, G])."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    nq, nk = Sq // Cq, Sk // Ck
    qpos, kpos = _chunk_positions(Sq, Sk, Cq, Ck, q_offset, kv_valid_len)
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(B, nq, Cq, K, G, hd)
    kr = k.reshape(B, nk, Ck, K, hd)
    vr = v.reshape(B, nk, Ck, K, hd)
    outs, lses = [], []
    for i in range(nq):
        qc = qr[:, i].to(torch.float32)
        m = torch.full((B, Cq, K, G), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Cq, K, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Cq, K, G, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            if not _visible(qpos[i], kpos[j], causal):
                continue
            kc, vc = kr[:, j], vr[:, j]
            s = torch.einsum("bqkgh,bckh->bqkgc", qc,
                             kc.to(torch.float32)) * scale
            s = torch.where(_mask(qpos[i], kpos[j], causal, q.device), s,
                            _NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            m_safe = torch.clamp_min(m_new, -0.5 * 1e30)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.clamp_min(m, -0.5 * 1e30) - m_safe)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckh->bqkgh", p.to(vc.dtype).to(torch.float32),
                vc.to(torch.float32))
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
        lses.append(torch.clamp_min(m, -0.5 * 1e30)
                    + torch.log(torch.clamp_min(l, 1e-30)))
    out = torch.stack(outs, dim=1).reshape(B, Sq, H, hd).to(q.dtype)
    return out, torch.stack(lses, dim=1)


def attention_backward_plain(q, k, v, o, lse, do, causal: bool, Cq: int,
                             Ck: int, q_offset: int, kv_valid_len):
    """The plain loop's backward -> (dq, dk, dv), recomputing each tile
    from (o, lse)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    nq, nk = Sq // Cq, Sk // Ck
    qpos, kpos = _chunk_positions(Sq, Sk, Cq, Ck, q_offset, kv_valid_len)
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qr = q.reshape(B, nq, Cq, K, G, hd).to(f32)
    dor = do.reshape(B, nq, Cq, K, G, hd).to(f32)
    orr = o.reshape(B, nq, Cq, K, G, hd).to(f32)
    delta = torch.sum(dor * orr, dim=-1)                 # [B,nq,Cq,K,G]
    kr = k.reshape(B, nk, Ck, K, hd).to(f32)
    vr = v.reshape(B, nk, Ck, K, hd).to(f32)
    dq = torch.zeros((B, nq, Cq, K, G, hd), dtype=f32, device=q.device)
    dks, dvs = [], []
    for j in range(nk):
        kc, vc = kr[:, j], vr[:, j]
        dk_j = torch.zeros((B, Ck, K, hd), dtype=f32, device=q.device)
        dv_j = torch.zeros((B, Ck, K, hd), dtype=f32, device=q.device)
        for i in range(nq):
            if not _visible(qpos[i], kpos[j], causal):
                continue
            qc, doc = qr[:, i], dor[:, i]
            s = torch.einsum("bqkgh,bckh->bqkgc", qc, kc) * scale
            s = torch.where(_mask(qpos[i], kpos[j], causal, q.device), s,
                            _NEG)
            p = torch.exp(s - lse[:, i][..., None])      # [B,Cq,K,G,Ck]
            dv_j = dv_j + torch.einsum("bqkgc,bqkgh->bckh", p, doc)
            dp = torch.einsum("bqkgh,bckh->bqkgc", doc, vc)
            ds = p * (dp - delta[:, i][..., None]) * scale
            dk_j = dk_j + torch.einsum("bqkgc,bqkgh->bckh", ds, qc)
            dq[:, i] = dq[:, i] + torch.einsum("bqkgc,bckh->bqkgh", ds, kc)
        dks.append(dk_j)
        dvs.append(dv_j)
    dq = dq.reshape(B, Sq, H, hd).to(q.dtype)
    dk = torch.stack(dks, dim=1).reshape(B, Sk, K, hd).to(k.dtype)
    dv = torch.stack(dvs, dim=1).reshape(B, Sk, K, hd).to(v.dtype)
    return dq, dk, dv


def kernel_head_dim(hd: int) -> int:
    """The head dim the kernel runs ``hd`` at (zero-padded to it)."""
    for d in HEAD_DIMS:
        if hd <= d:
            return d
    raise ValueError(f"attention kernel: head dim {hd} is over "
                     f"{HEAD_DIMS[-1]}")


def check_kernel_inputs(q, k, v):
    """The kernel's contract: bf16 q [B, Sq, H, hd], k and v [B, Sk, K,
    hd] on one CUDA device, H a multiple of K, hd <= 256. Returns the
    padded head dim."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention kernel: {name} must be bfloat16, "
                            f"got {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"attention kernel: {name} must be 4-d")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"attention kernel: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"attention kernel: {H} q heads over "
                         f"{k.shape[2]} kv heads")
    if not (q.device == k.device == v.device):
        raise ValueError("attention kernel: q, k, v on different devices")
    return kernel_head_dim(hd)


def _operand(x: torch.Tensor, hdp: int) -> torch.Tensor:
    """Contiguous, 16-byte aligned, head dim zero-padded to ``hdp``."""
    if x.shape[-1] != hdp:
        return F.pad(x, (0, hdp - x.shape[-1])).contiguous()
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _kv_end(Sk: int, kv_valid_len) -> int:
    return Sk if kv_valid_len is None else max(0, min(Sk, kv_valid_len))


def launch(entry: str, device, *args):
    """One K7 launch: the library's ``repro_<entry>`` on ``device``'s
    current stream. Forward and backward calls are counted together in
    ``launch.launches`` and in the recorder's ``attn.kernel`` counter."""
    code = getattr(kernel_lib(), f"repro_{entry}")(*args,
                                                    stream_ptr(device))
    launch.launches += 1
    spans.count("attn.kernel", 1)
    raise_on_error(entry, code)


launch.launches = 0


def attention_forward_kernel(q, k, v, causal: bool, q_offset: int = 0,
                             kv_valid_len=None):
    """The forward kernel: -> (out like q, lse [B, K, Sq * G] fp32)."""
    hdp = check_kernel_inputs(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qp, kp, vp = (_operand(t, hdp) for t in (q, k, v))
    out = torch.empty_like(qp)
    lse = torch.empty((B, K, Sq * (H // K)), dtype=torch.float32,
                      device=q.device)
    if out.numel():
        launch("attn_fwd", q.device, qp.data_ptr(), kp.data_ptr(),
               vp.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H,
               K, hdp, int(q_offset), _kv_end(Sk, kv_valid_len),
               int(bool(causal)), 1.0 / math.sqrt(hd))
    return (out if hdp == hd else out[..., :hd]), lse


def attention_backward_kernel(q, k, v, out, lse, do, causal: bool,
                              q_offset: int = 0, kv_valid_len=None):
    """The backward kernels: -> (dq, dk, dv) like q, k, v."""
    hdp = check_kernel_inputs(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qp, kp, vp, op, dop = (_operand(t, hdp)
                           for t in (q, k, v, out, do.to(q.dtype)))
    dq, dk, dv = (torch.empty_like(t) for t in (qp, kp, vp))
    if qp.numel() and kp.numel():
        delta = torch.empty_like(lse)
        launch("attn_bwd", q.device, qp.data_ptr(), kp.data_ptr(),
               vp.data_ptr(), op.data_ptr(), dop.data_ptr(), lse.data_ptr(),
               delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               B, Sq, Sk, H, K, hdp, int(q_offset),
               _kv_end(Sk, kv_valid_len), int(bool(causal)),
               1.0 / math.sqrt(hd))
    else:
        dq.zero_(), dk.zero_(), dv.zero_()
    if hdp != hd:
        dq, dk, dv = dq[..., :hd], dk[..., :hd], dv[..., :hd]
    return dq, dk, dv


# ---------------------------------------------------------------------------
# dispatch: CUDA -> kernel (or raise), anything else -> plain loop
# ---------------------------------------------------------------------------

def attention_forward(q, k, v, causal: bool, Cq: int, Ck: int,
                      q_offset: int, kv_valid_len):
    """-> (out, lse). The chunks (Cq, Ck) shape the plain loop only."""
    if q.device.type == "cuda":
        return attention_forward_kernel(q, k, v, causal, q_offset,
                                        kv_valid_len)
    return attention_forward_plain(q, k, v, causal, Cq, Ck, q_offset,
                                   kv_valid_len)


def attention_backward(q, k, v, out, lse, do, causal: bool, Cq: int,
                       Ck: int, q_offset: int, kv_valid_len):
    """-> (dq, dk, dv) from the forward's (out, lse)."""
    if q.device.type == "cuda":
        return attention_backward_kernel(q, k, v, out, lse, do, causal,
                                         q_offset, kv_valid_len)
    return attention_backward_plain(q, k, v, out, lse, do, causal, Cq, Ck,
                                    q_offset, kv_valid_len)
