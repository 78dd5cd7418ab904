"""Service-cost objective wire format for the metric/clustering domain.

Port of ``repro/core/costs.py``. For a candidate center set C and exponent
mu, the service cost of a point x is

    f_C(x)     = min_{c in C} d(x, c)^mu          (k-median mu=1, k-means mu=2)
    f_{C,r}(x) = 1[min_{c in C} d(x, c) <= r]     (ball density / coverage)

and Sum(f_C; X) is the clustering cost of C. A batch of Q queries travels
as a ``CostTable`` (host numpy arrays from ``encode_cost_queries``, or
tensors on the slab's device):

  centers float32 [Q, Cmax, dim]  candidate sets, zero-padded to Cmax
  cvalid  bool    [Q, Cmax]       slot c of set q holds a real center
  mu      float32 [Q]             distance exponent (cost mode, mu > 0)
  param   float32 [Q]             radius r (ball mode)
  mode    int32   [Q]             MODE_COST | MODE_BALL

A row whose ``cvalid`` is all-False estimates exactly 0 in both modes (the
padding element of ``pad_cost_table``).

``service_cost_values`` is the plain version of the wire semantics; the
hand-written kernel K5 (``repro_torch.kernels.servicecost``) computes the
same function. Distances use the one quadratic expansion
d2(x, c) = |x|^2 + |c|^2 - 2 x.c clamped at 0, as a full-fp32
``torch.matmul`` (TF32 is never turned on).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import device_of
from .funcs import powf

MODE_COST = 0
MODE_BALL = 1


class CostTable(NamedTuple):
    """Array wire format for a batch of Q service-cost queries."""

    centers: object  # float32 [Q, Cmax, dim]
    cvalid: object   # bool    [Q, Cmax]
    mu: object       # float32 [Q]
    param: object    # float32 [Q]
    mode: object     # int32   [Q]


_TABLE_DTYPES = (torch.float32, torch.bool, torch.float32, torch.float32,
                 torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class ServiceCostQuery:
    """One service-cost query: a center set + mode parameters."""

    centers: np.ndarray   # [m, dim]
    mu: float = 1.0
    mode: int = MODE_COST
    radius: float = 0.0


def cost_query(centers, mu: float = 1.0) -> ServiceCostQuery:
    """Clustering-cost query: Sum over x of min_c d(x, c)^mu."""
    c = np.atleast_2d(np.asarray(centers, np.float32))
    return ServiceCostQuery(centers=c, mu=float(mu))


def ball_query(centers, radius: float) -> ServiceCostQuery:
    """Ball-density query: # points within ``radius`` of the set (a single
    center gives the classic ball |B(q, r)|)."""
    c = np.atleast_2d(np.asarray(centers, np.float32))
    return ServiceCostQuery(centers=c, mode=MODE_BALL, radius=float(radius))


CostQueries = Union[ServiceCostQuery, Sequence[ServiceCostQuery], CostTable]


def encode_cost_queries(queries: CostQueries, cmax: Optional[int] = None
                        ) -> CostTable:
    """-> CostTable padded to a common Cmax. Accepts a single query, a
    sequence (ragged set sizes fine), or an already-encoded table."""
    if isinstance(queries, CostTable):
        return queries
    if isinstance(queries, ServiceCostQuery):
        queries = [queries]
    qs = list(queries)
    if not qs:
        raise ValueError("empty service-cost query batch")
    dims = {q.centers.shape[1] for q in qs}
    if len(dims) != 1:
        raise ValueError(f"mixed center dims {sorted(dims)} in one batch")
    dim = dims.pop()
    need = max(q.centers.shape[0] for q in qs)
    cm = need if cmax is None else int(cmax)
    if cm < need:
        raise ValueError(f"cmax={cm} < largest set size {need}")
    qn = len(qs)
    centers = np.zeros((qn, cm, dim), np.float32)
    cvalid = np.zeros((qn, cm), bool)
    mu = np.zeros((qn,), np.float32)
    param = np.zeros((qn,), np.float32)
    mode = np.zeros((qn,), np.int32)
    for i, q in enumerate(qs):
        m = q.centers.shape[0]
        centers[i, :m] = np.asarray(q.centers, np.float32)
        cvalid[i, :m] = True
        mu[i] = q.mu
        param[i] = q.radius
        mode[i] = q.mode
    return CostTable(centers=centers, cvalid=cvalid, mu=mu, param=param,
                     mode=mode)


def cost_table(center_sets, mu: float = 1.0) -> CostTable:
    """Encode a batch of center sets (sequence of [m_i, dim] arrays, or one
    [Q, m, dim] array) as cost-mode queries sharing one mu."""
    sets = (list(center_sets) if not hasattr(center_sets, "shape")
            else [center_sets[i] for i in range(center_sets.shape[0])])
    return encode_cost_queries([cost_query(c, mu) for c in sets])


def pad_cost_table(table: CostTable, q_pad: int) -> CostTable:
    """Pad to ``q_pad`` rows with null queries (no valid centers -> estimate
    exactly 0), so batches of one bucket share one launch shape."""
    q = table.mu.shape[0]
    if q >= q_pad:
        return table
    pad = q_pad - q
    return CostTable(
        centers=np.concatenate(
            [np.asarray(table.centers, np.float32),
             np.zeros((pad,) + tuple(np.shape(table.centers)[1:]),
                      np.float32)]),
        cvalid=np.concatenate([np.asarray(table.cvalid, bool),
                               np.zeros((pad, np.shape(table.cvalid)[1]),
                                        bool)]),
        mu=np.concatenate([np.asarray(table.mu, np.float32),
                           np.zeros((pad,), np.float32)]),
        param=np.concatenate([np.asarray(table.param, np.float32),
                              np.zeros((pad,), np.float32)]),
        mode=np.concatenate([np.asarray(table.mode, np.int32),
                             np.zeros((pad,), np.int32)]))


def table_to(table: CostTable, device) -> CostTable:
    """A CostTable (numpy or tensors) as contiguous tensors on ``device``."""
    out = []
    for x, dt in zip(table, _TABLE_DTYPES):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(
                x, dtype=np.dtype(str(dt).replace("torch.", ""))))
        out.append(x.to(device=device, dtype=dt).contiguous())
    return CostTable(*out)


def points_to(points, device=None) -> torch.Tensor:
    """Host array or tensor -> contiguous float32 [n, dim] on ``device``
    (default: the tensor's own device, else the card)."""
    dev = device_of(points, device)
    if not isinstance(points, torch.Tensor):
        points = torch.from_numpy(np.ascontiguousarray(points, np.float32))
    return points.to(device=dev, dtype=torch.float32).contiguous()


def sq_dists(centers, points) -> torch.Tensor:
    """Squared distances [m, c] via the one quadratic expansion of both the
    plain version and the kernel: (|c|^2 + |x|^2) - 2 c.x, clamped at 0.
    The dot products are one full-fp32 ``torch.matmul``."""
    ctr = centers.to(torch.float32)
    pts = points.to(torch.float32)
    dots = torch.matmul(ctr, pts.T)
    cn2 = torch.sum(ctr * ctr, dim=1)
    pn2 = torch.sum(pts * pts, dim=1)
    return torch.clamp_min(cn2[:, None] + pn2[None, :] - 2.0 * dots, 0.0)


def service_cost_values(points, table: CostTable) -> torch.Tensor:
    """Evaluate a cost table against points: [Q, Cmax, dim] x [c, dim]
    -> float32 [Q, c] of f-values (min-dist^mu, or the ball indicator).

    The plain version of the wire semantics; K5 computes the same function.
    ``table`` holds tensors on the points' device (``table_to``).
    """
    pts = points.to(torch.float32)
    ctr = table.centers
    qn, cm, dim = ctr.shape
    d2 = sq_dists(ctr.reshape(qn * cm, dim), pts)            # [Q*Cmax, c]
    d2 = torch.where(table.cvalid.reshape(-1)[:, None], d2,
                     torch.full_like(d2, float("inf")))
    mind2 = torch.amin(d2.reshape(qn, cm, -1), dim=1)          # [Q, c]
    finite = torch.isfinite(mind2)
    cost = torch.where(mind2 > 0,
                       powf(torch.clamp_min(mind2, 1e-38),
                            (0.5 * table.mu)[:, None]),
                       torch.zeros_like(mind2))
    r = table.param[:, None]
    ball = (mind2 <= r * r).to(torch.float32)
    out = torch.where((table.mode == MODE_BALL)[:, None], ball, cost)
    return torch.where(finite, out, torch.zeros_like(out))


def estimate_service_costs(points, probs, member, queries: CostQueries,
                           point_weights=None,
                           use_kernels: Optional[bool] = None
                           ) -> torch.Tensor:
    """Batched HT estimates of Q clustering costs / ball densities -> [Q].

    points/probs/member: the sampled slab (coords [c, dim] aligned with the
    MultiSketch probs/member fields, or a MetricSample restriction);
    queries: ServiceCostQuery batch or encoded CostTable. ``use_kernels``
    (default True) takes K5 (``kernels.servicecost.service_cost_slab``):
    one launch for the whole Q x Cmax batch on the card, its plain version
    for CPU tensors. ``use_kernels=False`` takes the plain version
    everywhere. ``point_weights``: optional per-slot data weights. Host
    inputs go to the card; tensors stay where they are.
    """
    from repro_torch.kernels.servicecost import (service_cost_slab,
                                                 service_cost_slab_plain)
    pts = points_to(points)
    dev = pts.device
    probs = torch.as_tensor(probs).to(device=dev, dtype=torch.float32)
    member = torch.as_tensor(member).to(device=dev, dtype=torch.bool)
    pw = (None if point_weights is None else torch.as_tensor(
        point_weights).to(device=dev, dtype=torch.float32).contiguous())
    table = table_to(encode_cost_queries(queries), dev)
    uk = True if use_kernels is None else use_kernels
    fn = service_cost_slab if uk else service_cost_slab_plain
    return fn(pts, probs.contiguous(), member.contiguous(), table,
              point_weights=pw)


def exact_service_costs(points, queries: CostQueries, point_weights=None,
                        device=None) -> torch.Tensor:
    """Ground-truth costs over the FULL point set (validation / the exact
    scorer of launch.cluster) -> [Q], plain torch on the points' device
    (host points go to ``device``, default the card)."""
    pts = points_to(points, device)
    table = table_to(encode_cost_queries(queries), pts.device)
    values = service_cost_values(pts, table)
    pw = (torch.ones(pts.shape[:1], dtype=torch.float32, device=pts.device)
          if point_weights is None else torch.as_tensor(point_weights).to(
              device=pts.device, dtype=torch.float32))
    return torch.matmul(values, pw)
