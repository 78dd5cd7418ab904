"""The reference's training steps: the plain model's loss and gradients
(``lm.loss``) over the step's microbatch parts, then AdamW with global-norm
clipping and a warmup-cosine schedule, all in float32 with TF32 off, from
the benchmark's own weights. Imports nothing of the program.

AdamW (decoupled weight decay on every leaf of two or more dims):
  g <- g min(1, clip / |g|),  m <- b1 m + (1 - b1) g,
  v <- b2 v + (1 - b2) g^2,
  p <- p - lr(t) (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p),
  lr(t) = peak t / warmup for t < warmup, else the cosine from peak to
  peak x min_frac over the remaining steps.
"""
from __future__ import annotations

import math

import torch

from bench import weights as Wt
from bench.reference import lm


def lr_at(opt: dict, t: int) -> float:
    warm = max(opt["warmup_steps"], 1)
    if t < opt["warmup_steps"]:
        return opt["peak_lr"] * t / warm
    frac = min(max((t - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    lo = opt["min_lr_frac"]
    return opt["peak_lr"] * (lo + (1 - lo) * 0.5 * (1 + math.cos(math.pi
                                                                 * frac)))


def follow(cfg, shapes: dict, seed: int, batches, parts: int, opt: dict,
           device, quant=None, keep_rows=None, frozen=False) -> dict:
    """Run len(batches) steps from the seed's weights. Returns per step the
    loss, and per leaf (sorted paths) the first step's gradient norm as
    clipped and unclipped, and each leaf's change over the steps.

    Faults for the checks' own readings: ``keep_rows``, the loss of each
    part over its first ``keep_rows`` rows alone; ``frozen``, steps that
    leave the state as it was."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(cfg, shapes, seed, batches, parts, opt, device, quant,
                       keep_rows, frozen)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _follow(cfg, shapes, seed, batches, parts, opt, device, quant,
            keep_rows, frozen):
    paths = sorted(shapes)
    W = {p: t.requires_grad_() for p, t in
         Wt.draw_all(shapes, seed, device).items()}
    M = {p: torch.zeros_like(W[p]) for p in paths}
    V = {p: torch.zeros_like(W[p]) for p in paths}
    b1, b2 = opt["b1"], opt["b2"]
    out = {"loss": []}
    for t, tokens in enumerate(batches, start=1):
        tokens = tokens.to(device)
        rows = tokens.shape[0] // parts
        G = None
        total = 0.0
        for j in range(parts):
            part = tokens[j * rows:(j + 1) * rows]
            if keep_rows is not None:
                part = part[:keep_rows]
            loss, _ = lm.loss(W, cfg, part, quant)
            grads = torch.autograd.grad(loss, [W[p] for p in paths])
            total += float(loss.detach())
            if G is None:
                G = list(grads)
            else:
                for g, h in zip(G, grads):
                    g.add_(h)
            del grads, loss
        for g in G:
            g.div_(parts)
        out["loss"].append(total / parts)
        gn = math.sqrt(sum(float(g.square().sum()) for g in G))
        scale = min(1.0, opt["clip_norm"] / max(gn, 1e-9))
        if t == 1:
            out["grad_norm"] = {p: float(g.norm()) for p, g in zip(paths, G)}
            out["grad_clipped"] = {p: out["grad_norm"][p] * scale
                                   for p in paths}
        lr = lr_at(opt, t)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        if frozen:                   # the state, its moments too, stay
            out["grad_clipped"] = dict.fromkeys(paths, 0.0)
            continue
        with torch.no_grad():
            for p, g in zip(paths, G):
                g = g * scale
                M[p].mul_(b1).add_(g, alpha=1 - b1)
                V[p].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (M[p] / c1) / ((V[p] / c2).sqrt() + opt["eps"])
                if W[p].ndim >= 2:
                    upd = upd + opt["weight_decay"] * W[p]
                W[p].sub_(lr * upd)
        del G
    del M, V
    with torch.no_grad():
        out["change"] = {}
        for i, p in enumerate(paths):
            w0 = Wt.draw_leaf(p, shapes[p], seed, i, device)
            out["change"][p] = float((W[p] - w0).norm())
            del w0
    return out
