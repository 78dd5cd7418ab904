"""AdamW with decoupled weight decay, global-norm clipping and a
warmup-cosine schedule, on nested-dict trees of tensors.

Port of ``repro/optim/adamw.py``. Every update allocates fresh tensors
(the caller's state stays valid). Weight decay applies to leaves with
``ndim >= 2``; under the stacked layer layout that includes the ``[L, d]``
norm scales and biases, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict[str, Any]:
    def zeros():
        return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
    dev = T.leaves(params)[0].device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, pspecs=None, mesh=None) -> torch.Tensor:
    """The l2 norm over every leaf of ``tree``. Placed (``pspecs`` and
    ``mesh``): each leaf is this rank's block, its sum of squares is
    summed over the mesh axes its pspec names (a leaf no axis splits is
    counted once), one all-reduce per set of axes. Leaves placed on no
    axis of size > 1 add up in tree order, as unplaced."""
    if pspecs is None:
        total = None
        for x in T.leaves(tree):
            s = torch.sum(torch.square(x.to(torch.float32)))
            total = s if total is None else total + s
        return torch.sqrt(total)
    from repro_torch.launch.mesh import all_reduce_sum_
    groups = {}
    for x, spec in zip(T.leaves(tree), T.leaves(pspecs)):
        axes = tuple(sorted({a for s in spec if s is not None
                             for a in (s if isinstance(s, tuple) else (s,))
                             if mesh.shape[a] > 1}))
        s = torch.sum(torch.square(x.to(torch.float32)))
        groups[axes] = s if axes not in groups else groups[axes] + s
    total = None
    for axes in sorted(groups):
        s = groups[axes].reshape(1).contiguous()
        for a in axes:
            s = all_reduce_sum_(mesh, a, s)
        total = s[0] if total is None else total + s[0]
    return torch.sqrt(total)


def apply_updates(params, grads, state, cfg: OptConfig, pspecs=None,
                  mesh=None):
    """Returns (new_params, new_state, metrics). Placed params (``pspecs``
    and ``mesh``): every leaf is this rank's block, the moments take the
    params' pspecs, and the clipping norm is ``global_norm``'s over the
    whole leaves."""
    step = state["step"] + 1
    gn = global_norm(grads, pspecs, mesh)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-9), 1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, stepf)
    c2 = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        # m' = b1 m + (1 - b1) g, v' = b2 v + (1 - b2) g^2, p' = p - lr
        # (m' / c1 / (sqrt(v' / c2) + eps) + wd p): each op in place on a
        # fresh tensor (the same bits as out of place), so at most four
        # leaf-sized temporaries live at once (a 2.8 GB leaf of zamba2-2.7b)
        g = g.to(torch.float32) * scale
        m = m * cfg.b1
        m += (1 - cfg.b1) * g
        sq = torch.square(g)
        del g
        sq *= 1 - cfg.b2
        v = v * cfg.b2
        v += sq
        del sq
        step_ = m / c1
        den = v / c2
        den.sqrt_()
        den += cfg.eps
        step_ /= den
        del den
        step_ += (cfg.weight_decay * p.to(torch.float32) if p.ndim >= 2
                  else 0.0)
        step_ *= lr
        return (p.to(torch.float32) - step_).to(p.dtype), m, v

    paths = [path for path, _ in T.flatten(params)]
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        T.leaves(params), T.leaves(grads), T.leaves(state["m"]),
        T.leaves(state["v"]))]
    new_p = T.unflatten(zip(paths, (o[0] for o in out)))
    new_m = T.unflatten(zip(paths, (o[1] for o in out)))
    new_v = T.unflatten(zip(paths, (o[2] for o in out)))
    return new_p, {"m": new_m, "v": new_v, "step": step}, {
        "grad_norm": gn, "lr": lr}
