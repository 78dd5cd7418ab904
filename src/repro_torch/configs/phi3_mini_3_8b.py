"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064, RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064, mlp_kind="swiglu", loss_chunk=1024,
)

SMOKE = ModelConfig(
    name="phi3-mini-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=128, mlp_kind="swiglu",
    attn_chunk=16, loss_chunk=16, ssm_chunk=8,
)
