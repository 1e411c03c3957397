"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE. [arXiv:2402.19173]

StarCoder2 uses LayerNorm with bias, plain-GELU FFN, and learned biases on
all projections. Code generation is the closest non-chemistry analogue of the
paper's copy-heavy drafting regime.
"""

from repro_torch.configs.base import ModelConfig, register


def CONFIG() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab_size=49152,
        use_bias=True, norm="layernorm", gated_ffn=False,
        pos="rope", rope_theta=100_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-reduced", family="dense",
        n_layers=2, d_model=192, n_heads=6, n_kv_heads=2,
        d_ff=768, vocab_size=512,
        use_bias=True, norm="layernorm", gated_ffn=False,
        pos="rope", rope_theta=100_000.0,
    )


register("starcoder2-15b", CONFIG, reduced)
