"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16, mamba1 arch. [arXiv:2410.05355; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, d_ff=0, vocab_size=65024,
    ssm_kind="mamba1", ssm_state=16, ssm_conv=4, ssm_expand=2,
    ssm_chunk=256, loss_chunk=1024, fsdp=True,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke", family="ssm",
    num_layers=2, d_model=64, d_ff=0, vocab_size=128,
    ssm_kind="mamba1", ssm_state=8, ssm_conv=4, ssm_expand=2,
    ssm_chunk=8, attn_chunk=16, loss_chunk=16,
)
