"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16, MHA) d_ff=5120
vocab=504 — encoder-only, wav2vec2-style backbone. [arXiv:2106.07447]

Encoder-only (bidirectional, causal=False): it has no autoregressive decode
step, so it trains (``transformer.apply(embeddings=...)``) and is not
served. The feature-extractor frontend is a stub: the model takes frame
embeddings (B, T, d_model); vocab 504 is the k-means target codebook.
"""

from repro_torch.configs.base import ModelConfig, register


def CONFIG() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab_size=504,
        use_bias=True, norm="layernorm", gated_ffn=False,
        pos="none", causal=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-reduced", family="audio",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=504,
        use_bias=True, norm="layernorm", gated_ffn=False,
        pos="none", causal=False,
    )


register("hubert-xlarge", CONFIG, reduced)
