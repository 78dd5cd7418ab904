"""The training, prefill and decode steps and the spec trees of their
inputs and state.

Port of ``repro/launch/steps.py``. The state is placed: every rank holds
the blocks of the params and moments that ``state_specs`` gives it
(``sharding.place``; FSDP leaves over ``data``, tensor-parallel leaves
over ``model``). Each rank runs the train step on its share of each
microbatch of the global batch (``sharding.batch_share``, as GSPMD shares
a part's rows): gradients are taken on them (an FSDP leaf's gradient
comes back as the rank's block of the mean over ``data``, from the
gather's backward; the others are averaged over the ``data`` group), then
reduced over the ``pod`` group densely or, with ``compress``, through the
sampled exchange (``distopt.compression``, one sample per block); AdamW
runs on the blocks, and with ``telemetry`` the step's loss is folded into
a device-resident MultiSketch. No train state is donated: every train
step returns fresh tensors and leaves its input valid. The prefill and decode steps take placed params and the global
batch, run on the rank's rows and give back the whole logits and the
cache placed by ``cache_pspecs``; the decode step writes into the cache
it is given (the reference's serve step donates its cache).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.multi_sketch import (MultiSketchSpec,
                                           multisketch_absorb_inline)
from repro_torch.launch import cost
from repro_torch.launch import sharding as Sh
from repro_torch.launch.cost import unrecorded
from repro_torch.launch.mesh import all_gather_dim, all_reduce_mean_
from repro_torch.launch.summary import multisketch_shape
from repro_torch.models import model as Mod
from repro_torch.models import parallel as P
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.telemetry import spans


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """The batch of (arch x shape) as meta-device tensors: the full
    sequence for train/prefill shapes (an encoder's frames and labels; a
    vlm's text after its ``frontend_tokens`` patches, S in all), one token
    per row for decode."""
    Mod.check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    meta = lambda dims, dtype: torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind not in ("train", "prefill"):
        return {"tokens": meta((B,), torch.int32)}
    if cfg.family == "encoder":
        return {"frames": meta((B, S, cfg.d_model), torch.bfloat16),
                "labels": meta((B, S), torch.int32)}
    if cfg.family == "vlm":
        P = cfg.frontend_tokens
        return {"tokens": meta((B, S - P), torch.int32),
                "patches": meta((B, P, cfg.d_model), torch.bfloat16)}
    return {"tokens": meta((B, S), torch.int32)}


def cache_abstract(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache of (arch x shape) as meta-device tensors (SSM
    states have no time axis: an ssm cache is the same at any seq_len)."""
    return Mod.make_cache(cfg, shape.global_batch, shape.seq_len,
                          device="meta")


def abstract_state(cfg: ModelConfig, telemetry=None):
    """(meta-device state tree, param spec tree): shapes only."""
    p, specs = Mod.abstract_params(cfg)
    meta = lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta")
    state = {"params": p, "opt": {
        "m": T.tree_map(meta, p), "v": T.tree_map(meta, p),
        "step": torch.empty((), dtype=torch.int32, device="meta")}}
    if telemetry is not None:
        state["tel"] = multisketch_shape(telemetry)
    return state, specs


def state_specs(cfg: ModelConfig, mesh, telemetry=None) -> dict:
    """Partition specs of the train state: params and both moments by the
    partition rules, the step and the telemetry slab replicated."""
    state, specs = abstract_state(cfg, telemetry)
    psp = Sh.param_pspecs(specs, state["params"], mesh, fsdp=cfg.fsdp)
    out = {"params": psp, "opt": {"m": psp, "v": psp, "step": ()}}
    if telemetry is not None:
        out["tel"] = type(state["tel"])(*(() for _ in state["tel"]))
    return out


def state_shardings(cfg: ModelConfig, mesh, telemetry=None):
    """(``NamedSharding`` tree of the train state, its meta-device shapes):
    the reference's ``state_shardings``."""
    specs = state_specs(cfg, mesh, telemetry)
    shapes = abstract_state(cfg, telemetry)[0]
    out = {"params": Sh.bind(mesh, specs["params"]),
           "opt": {"m": Sh.bind(mesh, specs["opt"]["m"]),
                   "v": Sh.bind(mesh, specs["opt"]["v"]),
                   "step": Sh.replicated(mesh)}}
    if telemetry is not None:
        out["tel"] = type(specs["tel"])(*(Sh.replicated(mesh)
                                          for _ in specs["tel"]))
    return out, shapes


def _gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' rows (their ``batch_slice``s) of the global batch, whole
    on every rank: gathered over data, then pod."""
    for a in ("data", "pod"):
        if a in mesh.axis_names:
            x = all_gather_dim(mesh, a, x.contiguous(), 0)
    return x


def _nrows(mesh) -> int:
    """The number of (pod, data) ranks the batch splits over."""
    n = 1
    for a in ("pod", "data"):
        n *= mesh.shape.get(a, 1)
    return n


def _rows(mesh, n: int):
    """This rank's rows of an n-row global batch, or all of them when n
    does not split over (pod, data) (the batch is then replicated, as the
    reference's ``batch_shardings`` leaves it)."""
    return Sh.batch_slice(mesh, n) if n % _nrows(mesh) == 0 else slice(0, n)


def _cache_dims(cfg, mesh, batch: int, length: int):
    """(cache pspecs of a [batch, length] cache, the per-layer k/v dim
    placed on ``model`` or None, {Mamba state leaf: its per-layer dim on
    ``model`` or None})."""
    with unrecorded():                     # a meta cache, for its shapes
        specs = Sh.cache_pspecs(Mod.make_cache(cfg, batch, length,
                                               device="meta"), cfg, mesh)
    dim = lambda sp: sp.index("model") - 1 if "model" in sp else None
    states = specs.get("mamba", {} if "k" in specs else specs)
    return (specs, dim(specs.get("k", ())),
            {k: dim(sp) for k, sp in states.items()})


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig, mesh,
                    grad_transform=None, microbatch: Optional[int] = None,
                    compress: Optional[dict] = None,
                    telemetry: Optional[MultiSketchSpec] = None):
    """Returns (step, state_specs); ``step(state, batch) -> (new_state,
    metrics)`` takes the GLOBAL batch (the same on every rank).

    grad_transform: optional fn(grads, params, step) -> grads applied
    between backward and optimizer.
    microbatch: cut the batch into ``microbatch`` parts of consecutive
    rows, each shared over the batch ranks as the reference's GSPMD
    shares it; their losses and gradients are summed in order, then
    divided (``compute_grads``). The batch must split into the parts.
    compress: dict of ``compressed_grads_fn`` kwargs; with a "pod" axis the
    cross-pod reduction is the sampled exchange.
    telemetry: a MultiSketchSpec; the state then carries a MultiSketch
    under "tel" and every step folds the per-example loss proxies into it
    (keys step * 2^16 + example, weight the step's loss), through K1-K3
    (the reference folds on its plain path; the two give identical
    slabs).
    """
    Mod.check_family(cfg)
    st_specs = state_specs(cfg, mesh, telemetry)
    psp = st_specs["params"]
    # under the sampled exchange a pod's loss is over the pod's batch
    sh = P.Shards(mesh, psp, ("data",) if compress is not None else None)

    def grads_once(params, batch, psh):
        model = Mod.Model(cfg, params, psh)
        with spans.span("train.forward"):
            loss, metrics = model(batch)
        named = list(model.named_parameters())
        # an encoder's token embedding is unused: its gradient is zeros,
        # as jax.grad gives it
        with spans.span("train.backward"):
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        allow_unused=True,
                                        materialize_grads=True)
        # a leaf's gradient may come back strided (the tied embedding's):
        # the collectives and the exchange take contiguous leaves
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                T.unflatten((n, g.contiguous())
                            for (n, _), g in zip(named, grads)))

    def mean_over(axis, loss, metrics, grads):
        """The mean over ``axis`` of the loss, metrics and every gradient
        leaf not placed on it (an FSDP block's gradient already is the
        mean over ``data``)."""
        names = sorted(metrics)
        packed = all_reduce_mean_(mesh, axis, torch.stack(
            [loss] + [metrics[m].to(torch.float32) for m in names]))
        return (packed[0], {m: packed[i + 1] for i, m in enumerate(names)},
                T.tree_map(lambda g, s: g if axis in s
                           else all_reduce_mean_(mesh, axis, g), grads, psp))

    def compute_grads(params, batch):
        """This pod's loss and gradients, as the reference's: ``batch``
        (global, or the pod's under ``compress``) cut into ``microbatch``
        parts of consecutive rows, the losses and gradients of each whole
        part summed in order and divided, then averaged over the data
        group. The rank takes its share of each part (``batch_share``
        over the batch ranks); a short or empty share is padded to the
        full share with the part's first row, which weighs zero but runs
        every collective with the other ranks."""
        n = next(iter(batch.values())).shape[0]
        parts = microbatch or 1
        if n % parts:
            raise ValueError(f"a batch of {n} rows does not split into "
                             f"{parts} microbatches")
        m = n // parts
        share, size = Sh.batch_share(mesh, m, sh.batch_axes)
        dev = next(iter(batch.values())).device
        pos = torch.arange(size, device=dev)
        valid = pos < share.stop - share.start
        rows = torch.where(valid, pos + share.start, 0)
        psh = sh.with_rows(valid, m)

        def part(j):
            return grads_once(params, {k: v.index_select(0, rows + j * m)
                                       for k, v in batch.items()}, psh)
        if parts == 1:
            return mean_over("data", *part(0))

        def accumulate(j, carry):
            loss_a, grads_a, _ = carry
            loss, metrics, grads = part(j)
            return (loss_a + loss, T.tree_map(torch.add, grads_a, grads),
                    metrics), None
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        (loss, grads, metrics), _ = cost.loop(
            parts, accumulate, (zero, T.tree_map(torch.zeros_like, params),
                                None))
        return mean_over("data", loss / parts, metrics,
                         T.tree_map(lambda g: g / parts, grads))

    compressed = None
    if compress is not None:
        from repro_torch.distopt.compression import compressed_grads_fn
        compressed = compressed_grads_fn(compute_grads, mesh, **compress)

    def step_fn(state, batch):
        with spans.span("train.step", next(iter(batch.values()))):
            return one_step(state, batch)

    def one_step(state, batch):
        params = state["params"]
        opt_step = state["opt"]["step"]
        if compressed is not None:
            # the pod's rows; the step seeds the exchange (a meta state, a
            # dry run, has no value to read, and its cost does not depend
            # on it)
            n = next(iter(batch.values())).shape[0]
            pod = Sh.batch_slice(mesh, n, ("pod",))
            step_no = 0 if opt_step.is_meta else int(opt_step)
            loss, metrics, grads = compressed(
                params, {k: v[pod] for k, v in batch.items()}, step_no)
        else:
            loss, metrics, grads = compute_grads(params, batch)
            if "pod" in mesh.axis_names:
                loss, metrics, grads = mean_over("pod", loss, metrics, grads)

        if grad_transform is not None:
            grads = grad_transform(grads, params, opt_step)

        with spans.span("train.update"):
            with torch.no_grad():
                new_params, new_opt, om = adamw.apply_updates(
                    params, grads, state["opt"], opt_cfg, pspecs=psp,
                    mesh=mesh)
            del grads
            new_state = {"params": new_params, "opt": new_opt}
            if telemetry is not None:
                # per-example loss proxies keyed step * 2^16 + example: the
                # stride is a CONSTANT so keys stay unique across a resume
                # with another --batch (b <= 65536, step < 32768 before
                # int32 wraps)
                b = next(iter(batch.values())).shape[0]
                dev = state["tel"].keys.device
                step_id = opt_step.to(device=dev, dtype=torch.int32)
                tkeys = step_id * (1 << 16) + torch.arange(
                    b, dtype=torch.int32, device=dev)
                new_state["tel"] = multisketch_absorb_inline(
                    telemetry, state["tel"], tkeys,
                    loss.to(device=dev, dtype=torch.float32).reshape(1)
                    .expand(b), use_kernels=True)
        return new_state, {"loss": loss, **metrics, **om}

    return step_fn, st_specs


def make_prefill_step(cfg: ModelConfig, mesh,
                      shape: Optional[ShapeConfig] = None):
    """Returns (step, param pspecs, cache pspecs: None without ``shape``,
    {} for an encoder); ``step(params, batch) -> (last-position logits
    [B, Vp], cache)`` (``Mod.prefill``; an encoder's is its inference
    forward and gives the cache {}). ``params`` are this rank's blocks
    (``sharding.place`` by the param pspecs), ``batch`` the global batch;
    the cache comes back placed by the cache pspecs of its own shape."""
    Mod.check_family(cfg)
    p, specs = Mod.abstract_params(cfg)
    psp = Sh.param_pspecs(specs, p, mesh, fsdp=cfg.fsdp)
    sh = P.Shards(mesh, psp)

    def step_fn(params, batch):
        n = next(iter(batch.values())).shape[0]
        local = {k: v[_rows(mesh, n)] for k, v in batch.items()}
        dim = states = None
        if cfg.family != "encoder":
            S = sum(v.shape[1] for k, v in batch.items()
                    if k in ("tokens", "patches"))
            _, dim, states = _cache_dims(cfg, mesh, n, S)
        logits, cache = Mod.prefill(params, cfg, local, sh, dim, states)
        if n % _nrows(mesh) == 0:
            logits = _gather_rows(mesh, logits)
        return logits, cache
    if shape is None:
        cache = None
    elif cfg.family == "encoder":
        cache = {}
    else:
        cache = Sh.cache_pspecs(cache_abstract(cfg, shape), cfg, mesh)
    return step_fn, psp, cache


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Single-token decode step against a ``shape.seq_len`` cache. Returns
    (step, param pspecs, cache pspecs); ``step(params, tokens, cache,
    index) -> (logits [B, Vp], cache)`` takes this rank's param blocks,
    the global tokens [B] and the cache placed by the cache pspecs, and
    writes into ``cache`` in place (``Mod.serve_step``)."""
    Mod.check_family(cfg)
    p, specs = Mod.abstract_params(cfg)
    psp = Sh.param_pspecs(specs, p, mesh, fsdp=cfg.fsdp)
    sh = P.Shards(mesh, psp)
    csp, dim, states = _cache_dims(cfg, mesh, shape.global_batch,
                                   shape.seq_len)

    def step_fn(params, tokens, cache, index):
        n = tokens.shape[0]
        logits, cache = Mod.serve_step(params, cfg, tokens[_rows(mesh, n)],
                                       cache, index, sh, dim, states)
        if n % _nrows(mesh) == 0:
            logits = _gather_rows(mesh, logits)
        return logits, cache
    return step_fn, psp, csp


def grow_placed_cache(cfg: ModelConfig, cache, specs, extra: int, mesh):
    """``Mod.grow_cache`` on a placed cache: gathered whole by its pspecs
    ``specs``, grown by ``extra`` slots, and placed again by the pspecs of
    the grown shape (the rule may pick another dim once S changes).
    Returns (cache, its pspecs)."""
    whole = Mod.grow_cache(cfg, Sh.unplace(cache, specs, mesh), extra)
    new = Sh.cache_pspecs(whole, cfg, mesh)
    return Sh.place(whole, new, mesh), new
