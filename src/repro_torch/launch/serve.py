"""Serving entry point: prefill + batched greedy decode, with request
telemetry behind the fault-tolerant pool.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        [--smoke] [--device cpu] --batch 4 --prompt-len 16 --gen 16

Port of ``repro/launch/serve.py``. A prompt batch (random tokens from
``--seed``) is prefilled, building the KV cache; the cache grows by
``--gen`` slots and tokens are decoded step by step, greedily. Request
statistics (prompt + generated length per request) flow through the
multi-tenant ``EnginePool`` (K1-K3 at absorb, K4 at query), and the
request shapes through ``ClusterEngine`` and ``local_search`` (K5).

Runs on the card unless ``--device cpu``. Serves the dense, MoE, ssm
(falcon-mamba: per-layer conv and SSM states, no KV cache), hybrid
(zamba2: SSM states and the shared attention block's KV cache) and vlm
families; an encoder has no decode step and exits. A vlm's prompt is
``frontend_tokens`` stub patch embeddings (standard normal from
``--seed``) before ``--prompt-len`` text tokens, and the chunked
attention of its prefill needs ``frontend_tokens + prompt_len`` to be at
most ``attn_chunk`` or a multiple of it. Its cache holds the patches
first, so decode step t runs at index ``frontend_tokens + prompt_len +
t`` (the reference's serve.py decodes from ``prompt_len``, inside the
prompt's slots). The request telemetry counts ``prompt_len + gen`` tokens
per request, as the reference's does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)
from repro_torch.core import (COUNT, EVERYTHING, SUM, MultiSketchSpec,
                              hash_fraction, thresh)
from repro_torch.launch.cluster import ClusterEngine, local_search
from repro_torch.launch.pool import EnginePool
from repro_torch.models import model as Mod


# request telemetry: tokens served, requests, requests of >= 16 tokens,
# over every request and over a 50 % coordinated key sample
REQUEST_OBJECTIVES = (SUM, COUNT, thresh(16.0))
REQUEST_SPEC = MultiSketchSpec(objectives=tuple(
    (f, 64) for f in REQUEST_OBJECTIVES))
REQUEST_PREDICATES = (EVERYTHING, hash_fraction(0.5, salt=1))


def request_features(generated: np.ndarray, total_len: int) -> np.ndarray:
    """Request shapes [B, 2]: total length and distinct generated tokens."""
    return np.stack(
        [np.full(len(generated), total_len, np.float32),
         np.array([len(np.unique(r)) for r in generated], np.float32)], 1)


def request_cluster_engine(batch: int, seed: int, device,
                           use_kernels=None) -> ClusterEngine:
    """The metric tier over request shapes (``use_kernels=False``: the
    plain versions everywhere)."""
    return ClusterEngine(dim=2, k=16, mu=2.0, n_anchors=min(4, batch),
                         seed=seed, device=device, use_kernels=use_kernels)


def _positive_int(v: str) -> int:
    i = int(v)
    if i < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {i}")
    return i


def build_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=_positive_int, default=4)
    ap.add_argument("--prompt-len", type=_positive_int, default=16)
    ap.add_argument("--gen", type=_positive_int, default=16,
                    help="tokens to generate (>= 1; 1 = prefill-only "
                         "argmax, no decode steps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    return ap.parse_args(argv)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, callback=None):
    """Serve one batch; returns {"tokens": [B, gen] generated ids,
    "prefill_ms", "decode_ms": per-step ms, "stats": the pool's answers
    [3, 2], "centers", "est_cost"}. ``callback(event, **info)`` sees
    ``"prefilled"``, ``"decoded"``, ``"absorbed"``, ``"queried"`` and
    ``"clustered"`` as each block ends."""
    args = build_args(argv)
    callback = callback or (lambda event, **info: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode step")
    Mod.check_family(cfg)
    P = cfg.frontend_tokens if cfg.family == "vlm" else 0
    S = P + args.prompt_len              # the prefill's positions
    if P and S > cfg.attn_chunk and S % cfg.attn_chunk:
        raise ValueError(
            f"{cfg.name}: frontend_tokens + prompt_len = {P} + "
            f"{args.prompt_len} = {S} must be at most attn_chunk = "
            f"{cfg.attn_chunk} or a multiple of it")
    dev = resolve_device(args.device)
    params, _ = Mod.init_model(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    if P:
        batch["patches"] = torch.randn(
            (args.batch, P, cfg.d_model), generator=gen, device=dev).to(
                torch.bfloat16)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = Mod.prefill(params, cfg, batch)
    cache = Mod.grow_cache(cfg, cache, args.gen)  # room for decode steps
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(dev)
    t_prefill = (time.perf_counter() - t0) * 1e3
    callback("prefilled", ms=t_prefill)

    # per-step times from events recorded between steps: the host never
    # waits inside the loop, so steps pipeline as in real serving
    outs = [tok]
    stamps = []

    def stamp():
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps.append(ev)
        else:
            stamps.append(time.perf_counter())
    stamp()
    for t in range(args.gen - 1):
        logits, cache = Mod.serve_step(params, cfg, tok, cache, S + t)
        tok = torch.argmax(logits, -1).to(torch.int32)
        outs.append(tok)
        stamp()
    _sync(dev)
    if dev.type == "cuda":
        steps = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
    else:
        steps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    generated = torch.stack(outs, 1).cpu().numpy()
    callback("decoded", ms=steps)

    print(f"prefill {args.batch}x{args.prompt_len}: {t_prefill:.1f} ms")
    if steps:   # gen == 1 decodes zero steps: no per-token rate
        print(f"decode {len(steps)} steps: {sum(steps) / len(steps):.2f} "
              f"ms/token (p50 {float(np.median(steps)):.2f})")
    else:
        print("decode 0 steps (prefill-only argmax)")
    print("generated token ids (first row):", generated[0][:12].tolist())

    # request telemetry through the fault-tolerant serving tier: ingest is
    # per-row quarantined, the dashboard batch is one fused segment-query
    # launch, and every answer carries its FRESH/STALE label
    pool = EnginePool(queue_depth=64, device=dev)
    pool.create_stream("requests", REQUEST_SPEC)
    receipt = pool.absorb(
        "requests", np.arange(args.batch),
        np.full(args.batch, float(args.prompt_len + args.gen)))
    callback("absorbed", receipt=receipt)
    fut = pool.submit("requests", REQUEST_OBJECTIVES, REQUEST_PREDICATES)
    pool.pump()
    resp = fut.result(timeout=30.0)
    if resp.values is None:
        raise RuntimeError(f"telemetry query {resp.status}: {resp.error}")
    stats = resp.values
    callback("queried", response=resp)
    print(f"[pool] stream=requests status={resp.status} "
          f"lag={resp.epoch_lag} overflow={resp.overflow} "
          f"quarantined={receipt.quarantined}")
    print("[telemetry] est total tokens served:", float(stats[0, 0]))
    print("[telemetry] est requests:", float(stats[1, 0]))
    print("[telemetry] est requests >= 16 tokens:", float(stats[2, 0]))
    print("[telemetry] est tokens, 50% coordinated key sample:",
          float(stats[0, 1]))

    # request-shape clustering: the metric tier over the same request log
    # (total length, distinct generated tokens per request)
    ceng = request_cluster_engine(args.batch, args.seed, dev)
    ceng.absorb(request_features(generated, args.prompt_len + args.gen))
    res = local_search(ceng, k=min(2, args.batch), rounds=4, n_cand=8)
    callback("clustered", result=res, engine=ceng)
    print("[cluster] request-shape centers:",
          np.round(res.centers, 2).tolist())
    print("[cluster] est k-means service cost:", round(res.est_cost, 3),
          flush=True)
    return {"tokens": generated, "prefill_ms": t_prefill,
            "decode_ms": steps, "stats": stats, "centers": res.centers,
            "est_cost": res.est_cost}


if __name__ == "__main__":
    main()
