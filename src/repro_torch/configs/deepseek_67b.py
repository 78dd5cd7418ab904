"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-arch. [arXiv:2401.02954; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400, mlp_kind="swiglu", loss_chunk=512,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=128, mlp_kind="swiglu",
    attn_chunk=16, loss_chunk=16, ssm_chunk=8,
)
