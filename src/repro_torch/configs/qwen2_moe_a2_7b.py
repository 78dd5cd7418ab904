"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 + 4 shared. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151936, num_experts=60, moe_top_k=4,
    num_shared_experts=4, mlp_kind="swiglu", qkv_bias=True,
    loss_chunk=512,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=128, num_experts=6, moe_top_k=2,
    num_shared_experts=2, mlp_kind="swiglu", qkv_bias=True,
    attn_chunk=16, loss_chunk=16, ssm_chunk=8,
)
