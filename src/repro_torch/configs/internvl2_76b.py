"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 (InternViT + InternLM2 backbone). Per spec the ViT frontend is a
STUB: input_specs() provides precomputed patch embeddings; we model the
LLM backbone over [patches | text]. [arXiv:2404.16821; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, mlp_kind="swiglu", rope_theta=1e6,
    frontend="patch", frontend_tokens=256, loss_chunk=512,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128, mlp_kind="swiglu", rope_theta=1e6,
    frontend="patch", frontend_tokens=8,
    attn_chunk=16, loss_chunk=16, ssm_chunk=8,
)
