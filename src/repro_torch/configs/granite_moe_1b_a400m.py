"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, num_experts=32, moe_top_k=8,
    num_shared_experts=0, mlp_kind="swiglu", tie_embeddings=True,
    loss_chunk=1024,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=128, num_experts=4, moe_top_k=2,
    num_shared_experts=0, mlp_kind="swiglu", tie_embeddings=True,
    attn_chunk=16, loss_chunk=16, ssm_chunk=8,
)
