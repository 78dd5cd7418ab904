"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, GQA + QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, mlp_kind="swiglu", qkv_bias=True,
    tie_embeddings=True, rope_theta=1e6, loss_chunk=512,
)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128, mlp_kind="swiglu", qkv_bias=True,
    tie_embeddings=True, rope_theta=1e6,
    attn_chunk=16, loss_chunk=16, ssm_chunk=8,
)
