"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504,
encoder-only (w2v2 arch). Modality frontend (conv feature extractor) is a
STUB per spec: input_specs() provides precomputed frame embeddings.
[arXiv:2106.07447; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504, mlp_kind="gelu", norm_kind="layernorm",
    causal=False, frontend="frames", loss_chunk=2048,
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="encoder",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=32, mlp_kind="gelu", norm_kind="layernorm",
    causal=False, frontend="frames",
    attn_chunk=16, loss_chunk=16, ssm_chunk=8,
)
