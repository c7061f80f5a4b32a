"""Config registry of the port: the architectures of the families it
has ported, dense, SSM, hybrid and MoE (with MLA).

``qwen2-7b``, ``mistral-nemo-12b``, ``mamba2-780m``, ``zamba2-7b``,
``qwen3-moe-30b-a3b`` and ``deepseek-v2-236b`` (multi-head latent
attention, shared experts, a leading dense layer; it serves, and its
training is refused) are the serving targets; the paper's LLaMA grid
(with ``llama-tiny``), ``mamba2-780m`` and ``zamba2-7b`` are what
training runs, and the small dense model the CPU tests run.
``internlm2-20b`` and ``mistral-large-123b`` are the registry's other
dense architectures.  Other architectures of ``repro.configs`` join as
their families are ported.
"""
from __future__ import annotations

from . import (deepseek_v2_236b, internlm2_20b, llama_paper, mamba2_780m,
               mistral_large_123b, mistral_nemo_12b, qwen2_7b,
               qwen3_moe_30b_a3b, zamba2_7b)
from .base import ModelConfig, TrainConfig

CONFIGS = {
    "qwen2-7b": qwen2_7b.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "mistral-nemo-12b": mistral_nemo_12b.CONFIG,
    "mistral-large-123b": mistral_large_123b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    "llama-20m": llama_paper.LLAMA_20M,
    "llama-60m": llama_paper.LLAMA_60M,
    "llama-100m": llama_paper.LLAMA_100M,
    "llama-tiny": llama_paper.LLAMA_TINY,
    "encoder-small": llama_paper.ENCODER_SMALL,
}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(
            f"unknown arch '{name}'; known: {sorted(CONFIGS)}")
    return CONFIGS[name]


__all__ = ["ModelConfig", "TrainConfig", "CONFIGS", "get_config"]
