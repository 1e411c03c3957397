"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
— llama-arch small, tied embeddings. [hf:HuggingFaceTB/SmolLM-135M]
"""

from repro_torch.configs.base import ModelConfig, register


def CONFIG() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
        d_ff=1536, vocab_size=49152,
        use_bias=False, norm="rmsnorm", gated_ffn=True,
        pos="rope", rope_theta=10_000.0, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-reduced", family="dense",
        n_layers=2, d_model=96, n_heads=3, n_kv_heads=1,
        d_ff=256, vocab_size=512,
        use_bias=False, norm="rmsnorm", gated_ffn=True,
        pos="rope", rope_theta=10_000.0, tie_embeddings=True,
    )


register("smollm-135m", CONFIG, reduced)
