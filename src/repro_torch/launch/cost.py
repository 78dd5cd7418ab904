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

  n_ops          the ops of the whole step; ``dispatched_ops`` the ops the
                 walk actually ran (fewer under trip counts, below)

Trip counts (the reference's ``known_trip_count``): a loop whose
iterations are alike — the layer stack of a train step, prefill or decode
step (``scan`` / ``loop`` in ``models/model.py``) and a train step's
microbatches (``launch/steps.py``) — walks its first iteration and books
the rest as that iteration's counts. A differentiable loop is one
autograd node past its first iteration (``_Repeat``): in backward it
walks one iteration's backward (with its recompute under remat) and books
the others. The bytes an iteration leaves alive (saved for backward, or
its outputs: a prefill's cache blocks) stand as placeholder storages of
their size, so the temporaries' peak is the full walk's; the booked
iterations' gradients of their own inputs are placeholders of their
shapes. All of this happens only under a recorder whose tensors are on
the meta device: elsewhere the loops run every iteration as written.
``recording(trip_counts=False)`` walks every iteration (to test the
booking against).

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
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.checkpoint import checkpoint
from torch.utils.weak import WeakIdKeyDictionary

_ACTIVE: list = []
# the counters a booked iteration adds to
_COUNTS = ("flops", "matmul_flops", "hbm_bytes", "transcendental",
           "coll_bytes", "coll_bytes_xpod", "n_ops")

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
    if rec is not None and not (rec.paused or rec.silent):
        rec.coll_bytes += nbytes
        rec.coll_ops[kind] = rec.coll_ops.get(kind, 0) + 1
        if crosses_pod:
            rec.coll_bytes_xpod += nbytes


def record_kernel(name: str, nbytes: int, ops: int = 0):
    """Book one call of a kernel's meta branch (no launch): the bytes it
    moves (inputs read once, outputs written once) and its operations."""
    rec = active()
    if rec is not None and not (rec.paused or rec.silent):
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

    def __init__(self, trip_counts: bool = True):
        self.flops = self.matmul_flops = self.hbm_bytes = 0
        self.transcendental = self.coll_bytes = self.coll_bytes_xpod = 0
        self.coll_ops: dict = {}
        self.kernels: dict = {}
        self.n_ops = self.dispatched = 0
        self.live = self.peak = 0
        self.paused = self.silent = False
        self.trip_counts = trip_counts
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
                "n_ops": self.n_ops, "dispatched_ops": self.dispatched}

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

    def placeholder(self, like=None, nbytes: int = 0):
        """A meta tensor shaped as ``like`` (or of ``nbytes`` bytes), whose
        storage counts as live while it exists but whose making is not
        counted: a booked iteration's saved bytes or outputs. It holds as
        large a storage as ``like`` does (a view keeps its base alive)."""
        was, self.silent = self.silent, True
        try:
            if like is None:
                return torch.empty((nbytes,), dtype=torch.uint8,
                                   device="meta")
            own = _nbytes(like)
            base = like.untyped_storage().nbytes()
            if base <= own or not like.is_contiguous():
                return torch.empty_like(like, device="meta")
            buf = torch.empty((base,), dtype=torch.uint8, device="meta")
            return buf[:own].view(like.dtype).view(like.shape)
        finally:
            self.silent = was

    # -- trip counts -------------------------------------------------------
    def _snapshot(self):
        return ({k: getattr(self, k) for k in _COUNTS}, dict(self.coll_ops),
                {k: dict(v) for k, v in self.kernels.items()})

    @contextlib.contextmanager
    def window(self):
        """Measure the stretch inside: yields a dict that then holds
        ``delta`` (its counts), ``left`` (the bytes it leaves alive) and
        ``rise`` (its peak above the live bytes it started from)."""
        (c0, ops0, k0), live0, peak0 = self._snapshot(), self.live, self.peak
        self.peak = self.live
        out = {}
        try:
            yield out
        finally:
            out["delta"] = (
                {k: getattr(self, k) - c0[k] for k in _COUNTS},
                {k: v - ops0.get(k, 0) for k, v in self.coll_ops.items()},
                {name: {f: v[f] - k0.get(name, {}).get(f, 0) for f in v}
                 for name, v in self.kernels.items()})
            out["left"] = self.live - live0
            out["rise"] = self.peak - live0
            self.peak = max(peak0, self.peak)

    def book(self, delta, rise: int = 0):
        """Book one more iteration: the counts ``delta`` (a ``window``'s),
        its peak ``rise`` above the live bytes now."""
        counts, ops, kernels = delta
        for k, v in counts.items():
            setattr(self, k, getattr(self, k) + v)
        for k, v in ops.items():
            if v:
                self.coll_ops[k] = self.coll_ops.get(k, 0) + v
        for name, v in kernels.items():
            if v["calls"]:
                have = self.kernels.setdefault(
                    name, {"calls": 0, "bytes": 0, "ops": 0})
                for f in have:
                    have[f] += v[f]
        self.peak = max(self.peak, self.live + rise)

    # -- one op ------------------------------------------------------------
    def op(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        packet = func.overloadpacket
        if self.paused or func.namespace not in ("aten", "prims"):
            return                       # collectives: booked by mesh.py
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if self.silent:
            for t in outs:
                self._track(t)
            return
        self.n_ops += 1
        self.dispatched += 1
        base = _base(packet.__name__)
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
def recording(held=(), trip_counts: bool = True):
    """Count every op and collective run inside the block into a new
    ``Cost`` (yielded); ``held``: tensors that exist before the call (its
    arguments), whose storages are not counted as its temporaries;
    ``trip_counts=False``: walk every iteration of every loop (tests)."""
    rec = Cost(trip_counts)
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


# ---------------------------------------------------------------------------
# loops with trip counts
# ---------------------------------------------------------------------------

def _booking(tree):
    """The active recorder when a loop over ``tree``'s tensors is to be
    trip-counted: one that books, over meta tensors; else None."""
    rec = active()
    if (rec is None or rec.paused or rec.silent or not rec.trip_counts
            or not any(isinstance(t, torch.Tensor) and t.is_meta
                       for t in tree_flatten(tree)[0])):
        return None
    return rec


def _direct(fn, *args):
    return fn(*args)


def _checkpointed(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def loop(n: int, body, carry):
    """``carry, out_i = body(i, carry)`` for i in range(n); returns
    (carry, [out_i]). No gradient may flow from one iteration to the next
    (``scan`` is the differentiable form). Under a booking recorder only
    iteration 0 is walked: the others book its counts and its peak, and
    their outputs are placeholders shaped as its own (the iterations must
    be alike, and leave nothing alive but their outputs)."""
    rec = _booking(carry)
    outs = []
    if rec is None or n < 2:
        for i in range(n):
            carry, o = body(i, carry)
            outs.append(o)
        return carry, outs
    with rec.window() as w:
        carry, o = body(0, carry)
    outs.append(o)
    for _ in range(1, n):
        rec.book(w["delta"], w["rise"])
        outs.append(tree_map(lambda t: rec.placeholder(t) if isinstance(
            t, torch.Tensor) else t, o))
    return carry, outs


def scan(body, carry: tuple, xs: list, shared=None, remat: bool = False):
    """``carry = body(carry, x, shared, call)`` for each x of ``xs`` in
    order; returns the last carry. ``carry``: a tuple of tensors; ``xs``:
    one tree of tensors per iteration, alike in shapes (a layer's
    params); ``shared``: a tree of tensors every iteration reads, or None;
    ``call(fn, *args)`` runs ``fn``, checkpointed (recomputed in backward)
    when ``remat`` and gradients are on. Under a booking recorder,
    iteration 0 is walked and the others are booked (``_Repeat``)."""
    grad = torch.is_grad_enabled()
    call = _checkpointed if remat and grad else _direct
    rec = _booking(carry)
    if rec is None or len(xs) < 2:
        for x in xs:
            carry = body(carry, x, shared, call)
        return carry
    with rec.window() as w:
        carry = body(carry, xs[0], shared, call)
    if not grad:
        for _ in xs[1:]:
            rec.book(w["delta"], w["rise"])
        return carry
    flat_x = [tree_flatten(x) for x in xs[1:]]
    flat_s, s_spec = tree_flatten(shared) if shared is not None else ([],
                                                                       None)
    spec = dict(rec=rec, body=body, call=call, fwd=w, ncarry=len(carry),
                x_spec=flat_x[0][1], nx=len(flat_x[0][0]), s_spec=s_spec,
                k=len(xs) - 1)
    return _Repeat.apply(spec, *carry, *(t for f, _ in flat_x for t in f),
                         *flat_s)


class _Repeat(torch.autograd.Function):
    """Iterations 1..k of a ``scan`` under a booking recorder, booked on
    iteration 0's counts. Inputs: the carry after iteration 0, the k
    iterations' ``xs`` tensors in order, then the shared tensors; output:
    the carry as it is (the iterations keep shapes). Backward runs the
    last iteration's forward on placeholder inputs unrecorded and walks
    its backward (with the recompute a checkpoint runs there), books it
    for the others, frees one iteration's saved bytes after each, and
    adds the k - 1 sums by which the engine accumulates a shared input's
    gradient over k iterations."""

    @staticmethod
    def forward(ctx, spec, *flat):
        rec, w, nc = spec["rec"], spec["fwd"], spec["ncarry"]
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        ctx.holds = []
        for _ in range(spec["k"]):
            rec.book(w["delta"], w["rise"])
            if w["left"] > 0:
                ctx.holds.append(rec.placeholder(nbytes=w["left"]))
        carry = flat[:nc]
        ctx.carry = [(t.shape, t.dtype, t.requires_grad) for t in carry]
        ctx.save_for_backward(*flat[nc + (spec["k"] - 1) * spec["nx"]:])
        out = tuple(t.view_as(t) for t in carry)
        ctx.mark_non_differentiable(*(o for o, t in zip(out, carry)
                                      if not t.requires_grad))
        return out

    @staticmethod
    def backward(ctx, *g_out):
        spec = ctx.spec
        rec, k, nx = spec["rec"], spec["k"], spec["nx"]
        saved = ctx.saved_tensors
        with unrecorded():
            c_in = [torch.empty(s, dtype=d, device="meta").requires_grad_(r)
                    for s, d, r in ctx.carry]
            leaves = [t.detach().requires_grad_(t.requires_grad)
                      for t in saved]
        x_in, s_in = leaves[:nx], leaves[nx:]
        ins = [t for t in c_in + leaves if t.requires_grad]
        with rec.window() as w:
            # the forward as the walk ran it, unrecorded: its checkpoint
            # (under remat) recomputes in the recorded backward
            with torch.enable_grad(), unrecorded():
                out = spec["body"](
                    tuple(c_in), tree_unflatten(x_in, spec["x_spec"]),
                    None if spec["s_spec"] is None
                    else tree_unflatten(s_in, spec["s_spec"]), spec["call"])
            pairs = [(o, g) for o, g in zip(out, g_out)
                     if g is not None and o.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], ins, [g for _, g in pairs],
                allow_unused=True))
            grads = [next(got) if t.requires_grad else None
                     for t in c_in + leaves]
            del out, pairs
        if ctx.holds:
            ctx.holds.pop()
        g_c, g_x, g_s = grads[:len(c_in)], grads[len(c_in):][:nx], \
            grads[len(c_in) + nx:]
        # the incoming gradient stays referenced by this call's arguments;
        # the full walk frees it once the last iteration consumed it
        spent = sum(_nbytes(g) for g in g_out if g is not None)
        booked = []
        for _ in range(k - 1):
            rec.book(w["delta"], w["rise"] - spent)
            if ctx.holds:
                ctx.holds.pop()
            booked.append([None if g is None else rec.placeholder(g)
                           for g in g_x])
        for g in g_s:
            if g is not None and k > 1:
                rec.book(({"flops": g.numel() * (k - 1),
                           "hbm_bytes": 3 * _nbytes(g) * (k - 1),
                           "n_ops": k - 1},
                          {}, {}))
        return (None, *g_c, *(g for b in booked for g in b), *g_x, *g_s)
