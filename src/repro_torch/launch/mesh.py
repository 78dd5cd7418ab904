"""Device meshes over ``torch.distributed``.

Port of ``repro/launch/mesh.py``. A ``Mesh`` lays the processes of the
default group out row-major over named axes, ``(pod, data, model)`` or
``(data, model)``, and holds one process group per axis (the ranks that
differ only in that axis's coordinate) and this rank's coordinates. Each
rank runs its own program and calls the collectives explicitly
(``all_reduce_mean_``, ``all_gather``), so the reference's
``shard_map_compat`` has no counterpart.

Without an initialised default group a mesh sets up a one-rank group on a
``HashStore`` (NCCL on the card, gloo on the CPU), so the same collective
calls run at world size 1 as across processes. Callers that run several
processes initialise the default group themselves
(``torch.distributed.init_process_group`` with a ``tcp://localhost:<port>``
address, the world size and the rank) before building a mesh. Groups on
gloo take CPU tensors: the collectives here stage CUDA tensors through the
host for them.

A ``model`` axis > 1 (tensor parallelism) is not ported yet.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch import resolve_device

AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


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

    def __init__(self, shape, axis_names, device=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        if dict(zip(axis_names, shape)).get("model", 1) > 1:
            raise NotImplementedError(
                "a 'model' mesh axis > 1 (tensor parallelism) is not ported "
                "yet: the tensor-parallel placement waits")
        dev = resolve_device(device)
        ensure_process_group(dev)
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {shape} needs {math.prod(shape)} "
                             f"processes, the default group has {world}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", dist.get_rank()
                               % torch.cuda.device_count())
        self.device = dev
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.rank = dist.get_rank()
        self.coords = dict(zip(axis_names, _unravel(self.rank, shape)))
        self._groups = {}
        for i, name in enumerate(axis_names):
            # every rank creates every group, in the same order
            for other in _product(shape[:i] + (1,) + shape[i + 1:]):
                ranks = [_ravel(other[:i] + (c,) + other[i + 1:], shape)
                         for c in range(shape[i])]
                group = dist.new_group(ranks)
                if self.rank in ranks:
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


def all_reduce_mean_(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous) becomes its mean over the ranks along ``axis``:
    the sum, then one division. Returns ``x``."""
    y = _staged(mesh, axis, x)
    dist.all_reduce(y, group=mesh.group(axis))
    y.div_(mesh.shape[axis])
    if y is not x:
        x.copy_(y)
    return x


def all_gather(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """[m, *x.shape]: ``x`` of every rank along ``axis``, in coordinate
    order, on x's device."""
    y = _staged(mesh, axis, x)
    out = [torch.empty_like(y) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, y, group=mesh.group(axis))
    return torch.stack(out).to(x.device)


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
    has that many processes, and (tensor parallelism) for the model axis
    of 16."""
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
