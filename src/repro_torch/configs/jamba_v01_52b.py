"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE every other
layer. [arXiv:2403.19887]

Block of 8 layers: one attention layer (position 4), seven Mamba layers;
MoE FFN on every other layer. Jamba uses no positional encoding (the Mamba
layers carry position); pos="none".
"""

from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig, register


def CONFIG() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        use_bias=False, norm="rmsnorm", gated_ffn=True, pos="none",
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        ffn_pattern=("dense", "moe") * 4,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-reduced", family="hybrid",
        n_layers=8, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512,
        use_bias=False, norm="rmsnorm", gated_ffn=True, pos="none",
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        ffn_pattern=("dense", "moe") * 4,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=512, capacity_factor=4.0),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    )


register("jamba-v0.1-52b", CONFIG, reduced)
