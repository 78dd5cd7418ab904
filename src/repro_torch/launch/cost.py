"""Per-rank cost of one call of a step, counted op by op on meta tensors.

Port of ``repro/launch/hlo_cost.py`` (with the memory figures of the
reference's ``compiled.memory_analysis()``). The reference parses the
compiled HLO of a whole step (per device after SPMD partitioning, while
bodies multiplied by their trip counts). The port has no compiled program:
each rank runs its own eager program, so its cost is the sum over the ops
that program issues, which this module counts as they run under a
``TorchDispatchMode`` (forward, backward and recomputation alike, since
every op of each is dispatched). Run on the meta device, the walk needs
no memory and no card. The keys are the reference's, for rank 0 over one
call of the step:

  flops          ``matmul_flops`` plus 1 per output element of every
                 elementwise op and 1 per input element of every reduction
                 (the reference's ``_ELEMENTWISE_FLOP`` and ``reduce``
                 rules), plus the operations a kernel's meta branch books
  matmul_flops   2·M·N·K of every product and convolution, by
                 ``torch.utils.flop_counter``'s registry (``FlopCounterMode``'s
                 count)
  hbm_bytes      operand and result bytes of every op that is not a view,
                 plus the bytes a kernel's meta branch books (its inputs
                 read once and its outputs written once). The eager port
                 materialises every op, so this reads higher than the
                 reference's count over fused HLO: the difference is real
  transcendental output elements of exp, log, tanh, rsqrt, sigmoid and the
                 like (silu, gelu and softplus included)
  coll_bytes / coll_bytes_xpod / coll_ops
                 operand bytes and counts of the collectives
                 ``launch/mesh.py`` issues (kinds named as the reference's
                 HLO names them); ``_xpod`` the share over the ``pod`` axis

Memory (``memory``): ``argument_size_in_bytes`` is what the caller says
the rank holds as the step's inputs (its placed state and its rows of the
batch); ``temp_size_in_bytes`` the peak of bytes allocated inside the call
and alive at once (storages, by the weak references torch keeps to them);
``output_size_in_bytes`` the bytes of the call's outputs that are not its
arguments; ``generated_code_size_in_bytes`` 0 (nothing is compiled).
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

_ACTIVE: list = []

# ops whose result is a view of an operand, or that move no data
_VIEWS = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "transpose", "t", "slice", "select",
    "unsqueeze", "squeeze", "as_strided", "alias", "detach", "split",
    "split_with_sizes", "unbind", "narrow", "diagonal", "view_as",
    "movedim", "unfold", "lift_fresh", "empty",
    "empty_like", "empty_strided", "resize_", "set_", "_local_scalar_dense",
    "is_same_size", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset",
}
_TRANSCENDENTAL = {
    "exp", "exp2", "log", "log1p", "log2", "log10", "expm1", "tanh",
    "sigmoid", "rsqrt", "sqrt", "cos", "sin", "erf", "pow", "silu", "gelu",
    "softplus", "silu_backward", "gelu_backward", "softplus_backward",
    "sigmoid_backward", "tanh_backward",
}
_ELEMENTWISE = _TRANSCENDENTAL | {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "bitwise_left_shift",
    "bitwise_right_shift", "__and__", "__or__", "__xor__", "__lshift__",
    "__rshift__", "floor", "ceil", "round", "trunc", "sign", "atan2",
    "remainder", "fmod", "clamp", "clamp_min", "clamp_max", "reciprocal",
    "square", "isfinite", "isinf", "isnan", "masked_fill", "lerp",
    "addcmul", "addcdiv", "threshold_backward", "floor_divide",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "cumsum", "cumprod", "var", "std", "norm", "linalg_vector_norm", "any",
    "all", "argmax", "argmin", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
}


def active():
    """The innermost recording ``Cost``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def record_collective(kind: str, nbytes: int, crosses_pod: bool):
    """Book one collective (``launch/mesh.py`` calls this for each one it
    issues) to the active recorder, if any."""
    rec = active()
    if rec is not None:
        rec.coll_bytes += nbytes
        rec.coll_ops[kind] = rec.coll_ops.get(kind, 0) + 1
        if crosses_pod:
            rec.coll_bytes_xpod += nbytes


def record_kernel(name: str, nbytes: int, ops: int = 0):
    """Book one call of a kernel's meta branch (no launch): the bytes it
    moves (inputs read once, outputs written once) and its operations."""
    rec = active()
    if rec is not None:
        rec.hbm_bytes += nbytes
        rec.flops += ops
        k = rec.kernels.setdefault(name, {"calls": 0, "bytes": 0, "ops": 0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["ops"] += ops


def _base(name: str) -> str:
    """An op's name without its in-place "_" and its "_foreach_" prefix."""
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name[len("_foreach_"):] if name.startswith("_foreach_") else name


def _conv_backward_flops(grad_out, x, w, output_mask) -> int:
    """A convolution's backward: the forward's 2·M·N·K (2 · weight elements
    · batch · output positions) for each of the input and weight gradients
    asked for. (``FlopCounterMode``'s own formula counts a grouped
    convolution's input gradient as if ungrouped: 65x a depthwise conv's
    at 64 channels.)"""
    fwd = 2 * w.numel() * grad_out.shape[0] * grad_out[0, 0].numel()
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Cost:
    """The counts of one recorded call (see the module docstring)."""

    def __init__(self):
        self.flops = self.matmul_flops = self.hbm_bytes = 0
        self.transcendental = self.coll_bytes = self.coll_bytes_xpod = 0
        self.coll_ops: dict = {}
        self.kernels: dict = {}
        self.n_ops = 0
        self.live = self.peak = 0
        self.paused = False
        self._seen = WeakIdKeyDictionary()

    def hlo_cost(self) -> dict:
        """The reference's ``hlo_cost.analyze`` keys, plus
        ``matmul_flops``, the kernels' bookings and the op count."""
        return {"flops": float(self.flops), "hbm_bytes": float(self.hbm_bytes),
                "coll_bytes": float(self.coll_bytes),
                "coll_bytes_xpod": float(self.coll_bytes_xpod),
                "coll_ops": dict(self.coll_ops),
                "transcendental": float(self.transcendental),
                "matmul_flops": float(self.matmul_flops),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "n_ops": self.n_ops}

    # -- memory ------------------------------------------------------------
    def hold(self, tensors):
        """Mark storages as held before the call (not counted as temp)."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self._seen[t.untyped_storage()] = 0

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int):
        self.live -= n

    # -- one op ------------------------------------------------------------
    def op(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        packet = func.overloadpacket
        if self.paused or func.namespace not in ("aten", "prims"):
            return                       # collectives: booked by mesh.py
        self.n_ops += 1
        base = _base(packet.__name__)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if base in _VIEWS:
            return
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if base == "convolution_backward":
            f = _conv_backward_flops(*args[:3], args[-1])
            self.matmul_flops += f
            self.flops += f
        elif packet in flop_registry:
            f = int(flop_registry[packet](*args, **(kwargs or {}),
                                          out_val=out))
            self.matmul_flops += f
            self.flops += f
        elif base in _REDUCTIONS:
            self.flops += ins[0].numel() if ins else 0
        elif base in _ELEMENTWISE:
            e = sum(t.numel() for t in outs)
            self.flops += e
            if base in _TRANSCENDENTAL:
                self.transcendental += e


class _Mode(TorchDispatchMode):
    def __init__(self, rec: Cost):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.rec.op(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def recording(held=()):
    """Count every op and collective run inside the block into a new
    ``Cost`` (yielded); ``held``: tensors that exist before the call (its
    arguments), whose storages are not counted as its temporaries."""
    rec = Cost()
    rec.hold(held)
    _ACTIVE.append(rec)
    try:
        with _Mode(rec):
            yield rec
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def unrecorded():
    """Ops run inside are bookkeeping of the caller, not the work being
    measured (a meta tree built only to read its shapes): the active
    recorder, if any, counts none of them."""
    rec = active()
    if rec is None:
        yield
        return
    was, rec.paused = rec.paused, True
    try:
        yield
    finally:
        rec.paused = was


def memory(rec: Cost, argument_bytes: int, outputs, held=()) -> dict:
    """The reference's ``memory_analysis`` keys for a recorded call whose
    arguments total ``argument_bytes`` and whose results are ``outputs``
    (storages among ``held`` are not outputs)."""
    held_ids = {id(t.untyped_storage()) for t in held
                if isinstance(t, torch.Tensor)}
    seen, out_bytes = set(), 0
    for t in tree_flatten(outputs)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) in held_ids or id(st) in seen:
                continue
            seen.add(id(st))
            out_bytes += st.nbytes()
    return {"argument_size_in_bytes": int(argument_bytes),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(rec.peak),
            "generated_code_size_in_bytes": 0}
