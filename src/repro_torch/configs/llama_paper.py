"""The paper's own pretraining models: LLaMA-20M / 60M / 100M
(Section 6.2.2: OpenWebText + T5-base tokenizer, seq 256).

Sizes follow the GaLore-lineage small-LLaMA grid the paper builds on.
"""
from .base import ModelConfig

_COMMON = dict(family="dense", vocab_size=32128, rope_theta=1e4,
               qkv_bias=False)

LLAMA_20M = ModelConfig(
    name="llama-20m", num_layers=4, d_model=384, num_heads=6,
    num_kv_heads=6, d_ff=1024, **_COMMON)

LLAMA_60M = ModelConfig(
    name="llama-60m", num_layers=8, d_model=512, num_heads=8,
    num_kv_heads=8, d_ff=1376, **_COMMON)

LLAMA_100M = ModelConfig(
    name="llama-100m", num_layers=12, d_model=640, num_heads=10,
    num_kv_heads=10, d_ff=1712, **_COMMON)

# Tiny stand-in used by CPU examples/benchmarks (same family, minutes not
# hours on one core).
LLAMA_TINY = ModelConfig(
    name="llama-tiny", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=384, family="dense", vocab_size=512,
    rope_theta=1e4, dtype="float32", param_dtype="float32",
    attn_chunk=128, loss_chunk=128)

# Scaled-down bidirectional encoder (the RoBERTa-large stand-in for the
# paper's Table 1/2/3 LR fine-tuning experiments).
ENCODER_SMALL = ModelConfig(
    name="encoder-small", family="dense", num_layers=4, d_model=256,
    num_heads=4, num_kv_heads=4, d_ff=683, vocab_size=1024,
    rope_theta=0.0, dtype="float32", param_dtype="float32",
    attn_chunk=128, loss_chunk=128)
