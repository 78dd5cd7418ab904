"""Statistic functions f for segment f-statistics Q(f, H) = sum f(w_x).

Port of ``repro/core/funcs.py``: count, sum, thresh_T, cap_T, moment_p and
non-negative linear combinations, as frozen (hashable) descriptors applied
to float32 tensors, and the disparity rho(f, g) of two of them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import as_1d, device_of


def powf(base: torch.Tensor, exponent) -> torch.Tensor:
    """base ** exponent elementwise in float32, as the kernels' ``powf``;
    ``exponent`` is a number or a tensor that broadcasts against base.

    On CUDA the exponent goes in as a tensor, so PyTorch calls ``powf``
    itself (with a Python scalar it would substitute sqrt, square, ... for
    special exponents), matching the kernels bit for bit. On the CPU
    PyTorch's vectorized ``pow`` rounds differently in the loop body and
    its scalar tail, which would make a slot's bits depend on its position
    in the batch; the power is therefore taken in float64 and rounded once.
    """
    e = torch.as_tensor(exponent, dtype=torch.float32, device=base.device)
    if base.device.type == "cuda":
        return torch.pow(base, e.expand_as(base))
    return torch.pow(base.to(torch.float64),
                     e.to(torch.float64)).to(torch.float32)


def moment_pow(w: torch.Tensor, p: float) -> torch.Tensor:
    """w ** p for w > 0, else 0 (float32), as ``powf(max(w, 1e-30), p)``."""
    wf = w.to(torch.float32)
    pw = powf(torch.clamp_min(wf, 1e-30), float(p))
    return torch.where(wf > 0, pw, torch.zeros_like(pw))


@dataclasses.dataclass(frozen=True)
class StatFn:
    """A statistic function f(w).

    kind: one of {"count", "sum", "thresh", "cap", "moment", "combo"}.
    param: scalar parameter (T for thresh/cap, p for moment).
    terms: for kind == "combo", tuple of (coef, StatFn) pairs.
    """

    kind: str
    param: float = 0.0
    terms: Tuple[Tuple[float, "StatFn"], ...] = ()

    def __call__(self, w) -> torch.Tensor:
        w = torch.as_tensor(w)
        if self.kind == "count":
            return (w > 0).to(torch.float32)
        if self.kind == "sum":
            return w.to(torch.float32)
        if self.kind == "thresh":
            return (w >= self.param).to(torch.float32)
        if self.kind == "cap":
            return torch.clamp_max(w, self.param).to(torch.float32)
        if self.kind == "moment":
            return moment_pow(w, self.param)
        if self.kind == "combo":
            out = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            for coef, g in self.terms:
                out = out + torch.tensor(coef, dtype=torch.float32) * g(w)
            return out
        raise ValueError(f"unknown StatFn kind: {self.kind}")

    @property
    def name(self) -> str:
        if self.kind in ("count", "sum"):
            return self.kind
        if self.kind in ("thresh", "cap", "moment"):
            return f"{self.kind}_{self.param:g}"
        return "combo(" + "+".join(f"{c:g}*{g.name}"
                                   for c, g in self.terms) + ")"

    def is_monotone(self) -> bool:
        """Every family above is monotone non-decreasing (paper §5)."""
        if self.kind == "combo":
            return all(c >= 0 and g.is_monotone() for c, g in self.terms)
        return True


COUNT = StatFn("count")
SUM = StatFn("sum")


def thresh(T: float) -> StatFn:
    return StatFn("thresh", float(T))


def cap(T: float) -> StatFn:
    return StatFn("cap", float(T))


def moment(p: float) -> StatFn:
    return StatFn("moment", float(p))


def combo(*terms: Tuple[float, StatFn]) -> StatFn:
    """Non-negative linear combination sum_i a_i g_i (paper Thm 4.1)."""
    for coef, _ in terms:
        if coef < 0:
            raise ValueError("closure (Thm 4.1) requires non-negative "
                             "coefficients")
    return StatFn("combo", 0.0, tuple((float(c), g) for c, g in terms))


def disparity(f: StatFn, g: StatFn, w_grid, device=None) -> torch.Tensor:
    """rho(f,g) = max_w f/g * max_w g/f over a weight grid (paper §2.4).

    Evaluated numerically on ``w_grid`` (w > 0); rho >= 1 with equality iff
    g = c f on the grid. Runs on ``device``, else on the grid's device when
    it is a tensor, else (a host array) on the card.
    """
    w = as_1d(w_grid, torch.float32, device_of(w_grid, device))
    fv = f(w)
    gv = g(w)
    ok = (fv > 0) & (gv > 0)
    zero = torch.zeros_like(fv)
    r1 = torch.where(ok, fv / torch.clamp_min(gv, 1e-30), zero).max()
    r2 = torch.where(ok, gv / torch.clamp_min(fv, 1e-30), zero).max()
    return r1 * r2
