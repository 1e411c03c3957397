"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers. [hf:meta-llama/Llama-3.2-11B-Vision]

40 layers = 32 self-attention + 8 gated cross-attention layers (every 5th).
The ViT / projector frontend is a stub: the backbone takes pre-computed
patch embeddings (memory_tokens x memory_dim) through its cross-attention
layers.
"""

from repro_torch.configs.base import ModelConfig, register


def CONFIG() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128_256,
        use_bias=False, norm="rmsnorm", gated_ffn=True,
        pos="rope", rope_theta=500_000.0,
        layer_pattern=("attn", "attn", "attn", "attn", "xattn"),
        ffn_pattern=("dense",) * 5,
        memory_tokens=1601, memory_dim=4096,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-reduced", family="vlm",
        n_layers=5, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512,
        use_bias=False, norm="rmsnorm", gated_ffn=True,
        pos="rope", rope_theta=500_000.0,
        layer_pattern=("attn", "attn", "attn", "attn", "xattn"),
        ffn_pattern=("dense",) * 5,
        memory_tokens=16, memory_dim=256,
    )


register("llama-3.2-vision-11b", CONFIG, reduced)
