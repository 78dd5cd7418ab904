"""The training, prefill and decode steps and the spec trees of their
inputs and state.

Port of ``repro/launch/steps.py``. Each rank runs the train step on its
rows of the global batch (``sharding.batch_slice``): gradients are taken
on them, averaged over the ``data`` group (the pod's batch), then over the
``pod`` group densely or, with ``compress``, through the sampled exchange
(``distopt.compression``); AdamW follows, and with ``telemetry`` the
step's loss is folded into a device-resident MultiSketch. No train state
is donated: every train step returns fresh tensors and leaves its input
valid. The decode step writes into the cache it is given (the
reference's serve step donates its cache).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.multi_sketch import (MultiSketchSpec,
                                           multisketch_absorb_inline)
from repro_torch.launch import sharding as Sh
from repro_torch.launch.mesh import all_reduce_mean_
from repro_torch.launch.summary import multisketch_shape
from repro_torch.models import model as Mod
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


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


def _check_placement(cfg: ModelConfig):
    Mod.check_family(cfg)
    if cfg.fsdp:
        raise NotImplementedError(
            f"{cfg.name}: FSDP placement is not ported yet")


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig, mesh,
                    grad_transform=None, microbatch: Optional[int] = None,
                    compress: Optional[dict] = None,
                    telemetry: Optional[MultiSketchSpec] = None):
    """Returns (step, state_specs); ``step(state, batch) -> (new_state,
    metrics)`` takes the GLOBAL batch (the same on every rank).

    grad_transform: optional fn(grads, params, step) -> grads applied
    between backward and optimizer.
    microbatch: split this rank's rows into ``microbatch`` sequential
    parts; their losses and gradients are summed in order, then divided.
    compress: dict of ``compressed_grads_fn`` kwargs; with a "pod" axis the
    cross-pod reduction is the sampled exchange.
    telemetry: a MultiSketchSpec; the state then carries a MultiSketch
    under "tel" and every step folds the per-example loss proxies into it
    (keys step * 2^16 + example, weight the step's loss), through K1-K3
    (the reference folds on its plain path; the two give identical
    slabs).
    """
    _check_placement(cfg)
    st_specs = state_specs(cfg, mesh, telemetry)

    def grads_once(params, batch):
        model = Mod.Model(cfg, params)
        loss, metrics = model(batch)
        named = list(model.named_parameters())
        # an encoder's token embedding is unused: its gradient is zeros,
        # as jax.grad gives it
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True,
                                    materialize_grads=True)
        # a leaf's gradient may come back strided (the tied embedding's):
        # the collectives and the exchange take contiguous leaves
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                T.unflatten((n, g.contiguous())
                            for (n, _), g in zip(named, grads)))

    def mean_over(axis, loss, metrics, grads):
        names = sorted(metrics)
        packed = all_reduce_mean_(mesh, axis, torch.stack(
            [loss] + [metrics[m].to(torch.float32) for m in names]))
        return (packed[0], {m: packed[i + 1] for i, m in enumerate(names)},
                T.tree_map(lambda g: all_reduce_mean_(mesh, axis, g), grads))

    def compute_grads(params, batch):
        """This pod's loss and gradients: this rank's rows (optionally in
        microbatches), averaged over the data group."""
        if microbatch and microbatch > 1:
            b = next(iter(batch.values())).shape[0]
            if b % microbatch:
                raise ValueError(f"{b} rows do not split into {microbatch} "
                                 f"microbatches")
            m = b // microbatch
            loss_a = torch.zeros((), dtype=torch.float32,
                                 device=next(iter(batch.values())).device)
            grads_a = T.tree_map(torch.zeros_like, params)
            for i in range(microbatch):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                loss, metrics, grads = grads_once(params, mb)
                loss_a = loss_a + loss
                grads_a = T.tree_map(torch.add, grads_a, grads)
            loss = loss_a / microbatch
            grads = T.tree_map(lambda g: g / microbatch, grads_a)
        else:
            loss, metrics, grads = grads_once(params, batch)
        return mean_over("data", loss, metrics, grads)

    compressed = None
    if compress is not None:
        from repro_torch.distopt.compression import compressed_grads_fn
        compressed = compressed_grads_fn(compute_grads, mesh, **compress)

    def step_fn(state, batch):
        params = state["params"]
        opt_step = state["opt"]["step"]
        rows = Sh.batch_slice(mesh, next(iter(batch.values())).shape[0])
        local = {k: v[rows] for k, v in batch.items()}
        if compressed is not None:
            loss, metrics, grads = compressed(params, local, int(opt_step))
        else:
            loss, metrics, grads = compute_grads(params, local)
            if "pod" in mesh.axis_names:
                loss, metrics, grads = mean_over("pod", loss, metrics, grads)

        if grad_transform is not None:
            grads = grad_transform(grads, params, opt_step)

        with torch.no_grad():
            new_params, new_opt, om = adamw.apply_updates(
                params, grads, state["opt"], opt_cfg)
        del grads
        new_state = {"params": new_params, "opt": new_opt}
        if telemetry is not None:
            # per-example loss proxies keyed step * 2^16 + example: the
            # stride is a CONSTANT so keys stay unique across a resume with
            # another --batch (b <= 65536, step < 32768 before int32 wraps)
            b = next(iter(batch.values())).shape[0]
            dev = state["tel"].keys.device
            step_id = opt_step.to(device=dev, dtype=torch.int32)
            tkeys = step_id * (1 << 16) + torch.arange(b, dtype=torch.int32,
                                                       device=dev)
            new_state["tel"] = multisketch_absorb_inline(
                telemetry, state["tel"], tkeys,
                loss.to(device=dev, dtype=torch.float32).reshape(1).expand(b),
                use_kernels=True)
        return new_state, {"loss": loss, **metrics, **om}

    return step_fn, st_specs


def make_prefill_step(cfg: ModelConfig, mesh,
                      shape: Optional[ShapeConfig] = None):
    """Returns (step, param pspecs, cache pspecs: None without ``shape``,
    {} for an encoder); ``step(params, batch) -> (last-position logits,
    cache)`` (``Mod.prefill``; an encoder's is its inference forward and
    gives the cache {})."""
    _check_placement(cfg)
    p, specs = Mod.abstract_params(cfg)
    psp = Sh.param_pspecs(specs, p, mesh)

    def step_fn(params, batch):
        return Mod.prefill(params, cfg, batch)
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
    index) -> (logits, cache)`` writes into ``cache`` in place
    (``Mod.serve_step``)."""
    _check_placement(cfg)
    p, specs = Mod.abstract_params(cfg)
    psp = Sh.param_pspecs(specs, p, mesh)

    def step_fn(params, tokens, cache, index):
        return Mod.serve_step(params, cfg, tokens, cache, index)
    return step_fn, psp, Sh.cache_pspecs(cache_abstract(cfg, shape), cfg,
                                         mesh)
