"""mamba2-780m [ssm] — attention-free SSD. [arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, rope_theta=0.0,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_dim=4,
    source="arXiv:2405.21060; unverified",
)
