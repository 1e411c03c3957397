"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01]

Command-R uses bias-free LayerNorm and SwiGLU FFN; rope_theta 8M.
"""

from repro_torch.configs.base import ModelConfig, register


def CONFIG() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22528, vocab_size=256_000,
        use_bias=False, norm="layernorm", gated_ffn=True,
        pos="rope", rope_theta=8_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-reduced", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512,
        use_bias=False, norm="layernorm", gated_ffn=True,
        pos="rope", rope_theta=8_000_000.0,
    )


register("command-r-35b", CONFIG, reduced)
