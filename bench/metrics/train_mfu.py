"""train_mfu (%), layer "train step": the model's FLOPs per step x the
window's steps / their time / the card's bf16 dense peak (989 TFLOP/s on
an H100 SXM, the model's compute dtype), x 100; steps under the profiler
left out. Moves train_tokens_per_s.

The FLOPs are the model's, from the configuration's published sizes, not
the program's: remat's second forward is not counted. Per token:

  6 x (the weight-matrix parameters a token passes through)
      attention q, k, v, o: d q + 2 d kv + q d, per attention application
      MoE: the router d E and the top-k experts' k 3 d f, per layer
      a shared block (hybrid): its attention and 3 d f MLP, once per
        application (num_layers / attn_every of them)
      Mamba-2, per layer: in-projections z and x (2 d di), B and C (2 d N),
        dt (d H), the out-projection di d
      the output head V d (the published vocabulary)
  + 6 S q per attention application (causal: half the S x S square,
      forward 2 S q, x 3 for forward and backward)
  + the SSD's chunk terms per Mamba-2 layer, x 3: within a chunk of Ck
      tokens, C B^T and the scores times x over the causal half,
      Ck (N + di); the state carried in and out, 4 N di.
"""
from bench.metrics.common import peak, untraced


def token_flops(m: dict, seq: int) -> float:
    d, L, V = m["d_model"], m["num_layers"], m["vocab_size"]
    q = m["num_heads"] * m["head_dim"]
    kv = m["num_kv_heads"] * m["head_dim"]
    attn = d * q + 2 * d * kv + q * d
    if m["family"] == "moe":
        f, E, k = m["d_ff"], m["num_experts"], m["moe_top_k"]
        mats = L * (attn + d * E + k * 3 * d * f) + V * d
        return 6 * mats + 6 * seq * q * L
    if m["family"] == "hybrid":
        di = m["ssm_expand"] * d
        N, H = m["ssm_state"], di // m["ssm_head_dim"]
        apps = L // m["attn_every"]
        mamba = 2 * d * di + 2 * d * N + d * H + di * d
        mats = L * mamba + apps * (attn + 3 * d * m["d_ff"]) + V * d
        ck = seq // max(seq // m["ssm_chunk"], 1)
        ssd = 3 * L * (ck * (N + di) + 4 * N * di)
        return 6 * mats + 6 * seq * q * apps + ssd
    raise ValueError(f"no FLOP formula for the family {m['family']!r}")


def step_flops(m: dict, rows: int, seq: int) -> float:
    return token_flops(m, seq) * rows * seq


def read(run):
    top = peak(run, "bf16_flops_per_s")
    steps = untraced(run)
    if top is None or not steps:
        return None
    cell = run.cell
    seq = cell.traffic["seq_len"]
    rows = run.tokens_per_step // seq
    secs = sum(s[3] - s[0] for s in steps)
    return 100.0 * step_flops(cell.config["model"], rows, seq) \
        * len(steps) / secs / top
