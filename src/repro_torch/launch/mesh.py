"""Device meshes over ``torch.distributed``.

Port of ``repro/launch/mesh.py``. A ``Mesh`` lays the processes of the
default group out row-major over named axes, ``(pod, data, model)`` or
``(data, model)``, and holds one process group per axis (the ranks that
differ only in that axis's coordinate) and this rank's coordinates. Each
rank runs its own program and calls the collectives explicitly
(``all_reduce_mean_``, ``all_reduce_sum_``, ``all_gather``,
``all_gather_dim``, ``reduce_scatter_mean``), so the reference's
``shard_map_compat`` has no counterpart. A mesh may also lay out a subset
of the default group's ranks (``ranks=``); every rank of the default group
still builds it, since process groups are created collectively.

The autograd pairs of tensor parallelism (Megatron's) are here too:
``copy_to`` (identity forward, sum over the axis backward), ``reduce_from``
(sum forward, identity backward) and ``gather_from`` (concatenate along a
dim forward, the rank's slice of the sum or mean backward).

Without an initialised default group a mesh sets up a one-rank group on a
``HashStore`` (NCCL on the card, gloo on the CPU), so the same collective
calls run at world size 1 as across processes. Callers that run several
processes initialise the default group themselves
(``torch.distributed.init_process_group`` with a ``tcp://localhost:<port>``
address, the world size and the rank) before building a mesh. Groups on
gloo take CPU tensors: the collectives here stage CUDA tensors through the
host for them. torch's gloo backend has no reduce-scatter, so
``reduce_scatter_mean`` is an all-reduce and then the rank's slice, on every
backend.

Every collective over an axis of more than one rank is booked to the
active cost recorder (``launch/cost.py``) as (kind, operand bytes, whether
its group crosses pods). ``init_dry_group`` sets up the default group of a
dry run: torch's ``fake`` backend at the production world size (256 or
512), so that ``make_production_mesh`` lays out the real mesh with its
real axis groups in one process, rank 0, and every collective returns at
once (on meta tensors it moves nothing). The default group lives as long
as the process, so a dry run takes a process of its own.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.launch.cost import record_collective

AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def init_dry_group(world: int):
    """Initialise the default group as rank 0 of ``world`` on torch's
    ``fake`` backend (no peers: every collective completes at once).
    Raises if a default group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists: a dry "
                           "run needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def ensure_process_group(device: torch.device):
    """Initialise a one-rank default group if none exists (NCCL for a CUDA
    device, gloo otherwise)."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


class Mesh:
    """Named axes over the default group's ranks (row-major), one process
    group per axis."""

    def __init__(self, shape, axis_names, device=None, ranks=None):
        """``ranks``: the default group's ranks the mesh lays out, in
        row-major order (default: all of them). Every rank of the default
        group must build the mesh; on a rank outside ``ranks`` it has no
        coordinates (``member`` is False) and no collective may be called
        on it."""
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        dev = resolve_device(device)
        ensure_process_group(dev)
        world = dist.get_world_size()
        ranks = list(range(world)) if ranks is None else list(ranks)
        if math.prod(shape) != len(ranks) or not set(ranks) <= set(
                range(world)):
            raise ValueError(f"mesh {shape} needs {math.prod(shape)} "
                             f"processes, the default group has {world}"
                             + ("" if len(ranks) == world
                                else f" (ranks {ranks} asked for)"))
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", dist.get_rank()
                               % torch.cuda.device_count())
        self.device = dev
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        me = dist.get_rank()
        self.member = me in ranks
        self.rank = ranks.index(me) if self.member else None
        self.coords = (dict(zip(axis_names, _unravel(self.rank, shape)))
                       if self.member else None)
        self._groups = {}
        for i, name in enumerate(axis_names):
            # every rank creates every group, in the same order
            for other in _product(shape[:i] + (1,) + shape[i + 1:]):
                members = [ranks[_ravel(other[:i] + (c,) + other[i + 1:],
                                        shape)] for c in range(shape[i])]
                group = dist.new_group(members)
                if me in members:
                    self._groups[name] = group

    def group(self, axis: str):
        return self._groups[axis]

    def stages_through_host(self, axis: str) -> bool:
        return dist.get_backend(self._groups[axis]) == "gloo"

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")


def _unravel(rank: int, shape) -> tuple:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def _product(shape):
    if not shape:
        yield ()
        return
    for c in range(shape[0]):
        for rest in _product(shape[1:]):
            yield (c,) + rest


# ---------------------------------------------------------------------------
# collectives over one axis
# ---------------------------------------------------------------------------

def _staged(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    if mesh.stages_through_host(axis) and x.device.type != "cpu":
        return x.cpu()
    return x.contiguous()


def _book(mesh: Mesh, axis: str, kind: str, x: torch.Tensor):
    """Book a collective over ``axis`` (more than one rank) to the cost
    recorder: only the pod axis's groups cross pods."""
    if mesh.shape[axis] > 1:
        record_collective(kind, x.numel() * x.element_size(),
                          axis == "pod")


def all_reduce_mean_(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous) becomes its mean over the ranks along ``axis``:
    the sum, then one division. Returns ``x``."""
    if mesh.shape[axis] == 1:
        return x
    _book(mesh, axis, "all-reduce", x)
    y = _staged(mesh, axis, x)
    dist.all_reduce(y, group=mesh.group(axis))
    y.div_(mesh.shape[axis])
    if y is not x:
        x.copy_(y)
    return x


def all_reduce_sum_(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous) becomes its sum over the ranks along ``axis``.
    Returns ``x``."""
    return _all_reduce_(mesh, axis, x, dist.ReduceOp.SUM)


def all_reduce_max_(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous) becomes its elementwise maximum over the ranks
    along ``axis``. Returns ``x``."""
    return _all_reduce_(mesh, axis, x, dist.ReduceOp.MAX)


def _all_reduce_(mesh, axis, x, op):
    if mesh.shape[axis] == 1:
        return x
    _book(mesh, axis, "all-reduce", x)
    y = _staged(mesh, axis, x)
    dist.all_reduce(y, op=op, group=mesh.group(axis))
    if y is not x:
        x.copy_(y)
    return x


def _gathered(mesh, axis, x) -> list:
    _book(mesh, axis, "all-gather", x)
    y = _staged(mesh, axis, x)
    out = [torch.empty_like(y) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, y, group=mesh.group(axis))
    return out


def all_gather(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """[m, *x.shape]: ``x`` of every rank along ``axis``, in coordinate
    order, on x's device (a copy of ``x`` on an axis of size 1)."""
    if mesh.shape[axis] == 1:
        return torch.stack([x])
    return torch.stack(_gathered(mesh, axis, x)).to(x.device)


def all_gather_dim(mesh: Mesh, axis: str, x: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """``x`` of every rank along ``axis`` concatenated along tensor dim
    ``dim``, in coordinate order, on x's device (``x`` itself on an axis
    of size 1)."""
    if mesh.shape[axis] == 1:
        return x
    return torch.cat(_gathered(mesh, axis, x), dim=dim).to(x.device)


def _block(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Block i of n along ``dim``, a copy (a view would keep all of x
    alive: an FSDP block's gradient, the whole layer's)."""
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size).clone(
        memory_format=torch.contiguous_format)


def reduce_scatter_sum(mesh: Mesh, axis: str, x: torch.Tensor,
                       dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks
    along ``axis``: an all-reduce, then the slice (torch's gloo has no
    reduce-scatter). ``x`` is left as it is."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    _book(mesh, axis, "all-reduce", x)
    if mesh.stages_through_host(axis) and x.device.type != "cpu":
        y = x.to("cpu").contiguous()      # the host copy is the buffer
    else:
        y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.group(axis))
    return _block(y, dim, n, mesh.coords[axis]).to(x.device)


def reduce_scatter_mean(mesh: Mesh, axis: str, x: torch.Tensor,
                        dim: int) -> torch.Tensor:
    """``reduce_scatter_sum`` divided by the axis's size."""
    n = mesh.shape[axis]
    return x if n == 1 else reduce_scatter_sum(mesh, axis, x, dim).div_(n)


# ---------------------------------------------------------------------------
# the autograd pairs of tensor parallelism (and FSDP's gather)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(ctx.mesh, ctx.axis,
                               g.contiguous().clone()), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        y = all_reduce_sum_(mesh, axis, x.contiguous().clone())
        return y.div_(mesh.shape[axis]) if mean else y

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, mean):
        ctx.args = (mesh, axis, dim, mean)
        return all_gather_dim(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, mean = ctx.args
        scatter = reduce_scatter_mean if mean else reduce_scatter_sum
        return scatter(mesh, axis, g, dim), None, None, None, None


def copy_to(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Identity forward; backward sums the gradient over ``axis``. Marks a
    tensor that every rank holds whole entering work that each rank does
    a part of (Megatron's f)."""
    return x if mesh.shape[axis] == 1 else _CopyTo.apply(x, mesh, axis)


def reduce_from(mesh: Mesh, axis: str, x: torch.Tensor,
                mean: bool = False) -> torch.Tensor:
    """The sum (``mean``: the mean) over ``axis`` forward; identity
    backward: the ranks' parts of a result made whole (Megatron's g)."""
    if mesh.shape[axis] == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis, mean)


def gather_from(mesh: Mesh, axis: str, x: torch.Tensor, dim: int,
                mean: bool = False) -> torch.Tensor:
    """``all_gather_dim`` forward; backward this rank's block of the
    gradient summed (``mean``: averaged) over ``axis``. Over ``model`` the
    ranks' gradients are parts of one sum; over ``data`` (FSDP) they are
    the gradients of the ranks' rows, whose mean the step takes."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim, mean)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def mesh_context(mesh):
    """The reference enters an ambient mesh; each torch rank already runs
    its own program, so this only yields the mesh."""
    yield mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production layouts: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model). Raises unless the default group
    has that many processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = AXES[len(shape)]
    if dist.is_initialized() and dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} processes, the default group "
                         f"has {dist.get_world_size()}")
    return Mesh(shape, axes, device=device)


def make_host_mesh(model_axis: int = 1, device=None) -> Mesh:
    """(data, model) over every process of the default group (one, when
    none is initialised)."""
    ensure_process_group(resolve_device(device))
    n = dist.get_world_size()
    return Mesh((n // model_axis, model_axis), ("data", "model"),
                device=device)


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
