"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B]
"""

from repro_torch.configs.base import ModelConfig, register


def CONFIG() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12288, vocab_size=151_936,
        qk_norm=True, use_bias=False, norm="rmsnorm", gated_ffn=True,
        pos="rope", rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-reduced", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512,
        qk_norm=True, use_bias=False, norm="rmsnorm", gated_ffn=True,
        pos="rope", rope_theta=1_000_000.0,
    )


register("qwen3-8b", CONFIG, reduced)
