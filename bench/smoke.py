"""Benchmark cells cut to a size that the CPU tests can run: the same
files, runner, reference and checks, with the model's widths, depth and
vocabulary, the sequence and the exchange's k made tiny.

A tiny model averages its rounding over few elements, and its few experts
flip routes under bf16 logits, so the bf16 program's gaps to the float32
reference are wider here than at the cells' own sizes and swing from seed
to seed. Over seeds 1-12 of each smoke cell, sound runs read at most
loss_gap 1.39e-3, grad_gap 6.46e-2, grad_med 3.80e-3 and change_gap
3.38e-3; half of each batch left out reads at least 4.27e-3, 0.105,
7.65e-3 and 0.132 (and fails change_gap on every seed). The smoke limits
sit between. The float8 control reads at least 5.7e-4, 1.6e-2, 1.7e-3 and
2.8e-3 there: it does not separate from the program at this size on the
dense cell by any number, so its verdict is held at each cell's own size
on the card (``bench/calibrate.py``).

No cell runs the hybrid family (Mamba-2 layers and a shared attention
block) yet; ``HYBRID`` holds the port's zamba2-2.7b sizes
(``repro_torch/configs/zamba2_2_7b.py``) so that the tests hold the hybrid
reference, FLOP terms and weight draws that a later cell of that family
uses."""
from __future__ import annotations

from bench import harness as H

SMOKE_MODEL = {
    "moe": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, d_ff=32, vocab_size=128, num_experts=4,
                moe_top_k=2, attn_chunk=16, loss_chunk=16),
    "hybrid": dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                   head_dim=16, d_ff=128, vocab_size=128, ssm_state=8,
                   ssm_head_dim=16, ssm_chunk=8, attn_every=2,
                   attn_chunk=16, loss_chunk=16),
}

SMOKE_LIMITS = {"loss_gap": 0.01, "grad_gap": 0.08, "grad_med": 0.005,
                "change_gap": 0.02, "tel_miss": 0, "sample_miss": 0}

HYBRID = {
    "name": "zamba2-2.7b",
    "model": {
        "name": "zamba2-2.7b", "family": "hybrid", "num_layers": 54,
        "d_model": 2560, "num_heads": 32, "num_kv_heads": 32,
        "head_dim": 80, "d_ff": 10240, "vocab_size": 32000,
        "ssm_kind": "mamba2", "ssm_state": 64, "ssm_conv": 4,
        "ssm_expand": 2, "ssm_head_dim": 64, "ssm_chunk": 256,
        "attn_every": 6, "mlp_kind": "swiglu", "tie_embeddings": False,
        "rope_theta": 10000.0, "norm_eps": 1e-06, "loss_chunk": 1024},
    "dtypes": {"params": "float32", "compute": "bfloat16",
               "optimizer": "float32"},
    "batch_ranks": 128,
    "microbatch": 1,
}
CONFIGS = {HYBRID["name"]: HYBRID}


def _split(name: str):
    """(config, traffic) of a cell name: the longest configuration name
    that prefixes it."""
    configs = [p.stem for p in (H.BENCH / "configs").glob("*.json")]
    configs = sorted(configs + list(CONFIGS), key=len, reverse=True)
    config = next(c for c in configs if name.startswith(c + "."))
    return config, name[len(config) + 1:]


def full(name: str):
    """The cell ``name`` (``<config>.<traffic>`` of ``bench/configs``, or
    of ``CONFIGS``, and ``bench/traffic``) at its own size."""
    config, traffic = _split(name)
    return H.make_cell(name, CONFIGS.get(config)
                       or H.BENCH / "configs" / f"{config}.json", traffic)


def cell(name: str, rows: int = 4, seq: int = 32):
    """The cell ``name`` at smoke size, held to the smoke limits."""
    c = full(name)
    c.config["model"].update(SMOKE_MODEL[c.config["model"]["family"]])
    c.traffic["seq_len"] = seq
    c.traffic["global_batch"] = rows * c.config["batch_ranks"]
    c.traffic["n_docs"] = 200
    if c.traffic.get("exchange"):
        c.traffic["exchange"].update(k=16, min_size=2048)
    c.limits = {k: v for k, v in SMOKE_LIMITS.items()
                if k != "sample_miss" or c.traffic.get("exchange")}
    return c
