"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2 — every layer MoE. [hf:microsoft/Phi-3.5-MoE-instruct]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register


def CONFIG() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab_size=32064,
        use_bias=False, norm="rmsnorm", gated_ffn=True,
        pos="rope", rope_theta=10_000.0,
        layer_pattern=("attn",), ffn_pattern=("moe",),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b-reduced", family="moe",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512,
        use_bias=False, norm="rmsnorm", gated_ffn=True,
        pos="rope", rope_theta=10_000.0,
        layer_pattern=("attn",), ffn_pattern=("moe",),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=512, capacity_factor=4.0),
    )


register("phi3.5-moe-42b-a6.6b", CONFIG, reduced)
