"""zamba2-7b [hybrid] — Mamba2 backbone + ONE shared attention+MLP block
reused every 6 layers (weight sharing). [arXiv:2411.15242; unverified]

The reference's adaptation, kept: the shared block consumes the residual
stream directly (the published model concatenates the original embedding
and uses per-application LoRA on the shared weights).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, rope_theta=1e4,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv_dim=4,
    attn_every=6,
    source="arXiv:2411.15242; unverified",
)
