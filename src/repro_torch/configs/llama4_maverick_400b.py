"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Llama-4 interleaves dense and MoE layers (every other layer MoE) and adds an
always-on shared expert alongside the 128 routed experts (top-1 routing).
"Early fusion" multimodality means image tokens share the token sequence,
so the backbone serves token ids like any decoder-only model.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register


def CONFIG() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202_048,
        use_bias=False, norm="rmsnorm", gated_ffn=True,
        pos="rope", rope_theta=500_000.0,
        layer_pattern=("attn", "attn"),
        ffn_pattern=("dense", "moe"),
        moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192, shared_expert=True),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b-reduced", family="moe",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512,
        use_bias=False, norm="rmsnorm", gated_ffn=True,
        pos="rope", rope_theta=500_000.0,
        layer_pattern=("attn", "attn"),
        ffn_pattern=("dense", "moe"),
        moe=MoEConfig(n_experts=4, top_k=1, d_ff=512, shared_expert=True,
                      capacity_factor=4.0),
    )


register("llama4-maverick-400b-a17b", CONFIG, reduced)
