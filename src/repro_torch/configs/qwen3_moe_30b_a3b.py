"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, qk-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
    num_experts=128, top_k=8, moe_d_ff=768, norm_topk=True,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
