"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64, Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_kind="mamba2", ssm_state=64, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=64, ssm_chunk=256, attn_every=6, loss_chunk=1024,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=128,
    ssm_kind="mamba2", ssm_state=8, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=16, ssm_chunk=8, attn_every=2,
    attn_chunk=16, loss_chunk=16,
)
