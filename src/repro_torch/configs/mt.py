"""Molecular Transformer configs (the paper's own model, Appendix A).

mt_product: 4 encoder + 4 decoder layers, d_model=256, 8 heads, d_ff=2048
            — reaction product prediction.
mt_retro:   6 + 6 layers, same widths — single-step retrosynthesis.

``vocab_size`` here is a stand-in; runtime code rebuilds the config with the
actual tokenizer vocab via ``with_vocab``.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, register


def _mt(name: str, depth: int) -> ModelConfig:
    return ModelConfig(
        name=name, family="seq2seq",
        n_layers=depth, n_encoder_layers=depth,
        d_model=256, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab_size=320,
        use_bias=True, norm="layernorm", gated_ffn=False,
        pos="sinusoidal", max_len=512,
    )


def product_config() -> ModelConfig:
    return _mt("mt-product", 4)


def retro_config() -> ModelConfig:
    return _mt("mt-retro", 6)


def with_vocab(cfg: ModelConfig, vocab_size: int) -> ModelConfig:
    return dataclasses.replace(cfg, vocab_size=vocab_size)


def tiny_config(vocab_size: int = 64, *, depth: int = 2, d_model: int = 128,
                max_len: int = 160) -> ModelConfig:
    """CPU-sized toy MT for tests."""
    return ModelConfig(
        name="mt-tiny", family="seq2seq",
        n_layers=depth, n_encoder_layers=depth,
        d_model=d_model, n_heads=4, n_kv_heads=4,
        d_ff=4 * d_model, vocab_size=vocab_size,
        use_bias=True, norm="layernorm", gated_ffn=False,
        pos="sinusoidal", max_len=max_len,
    )


def _reduced_product() -> ModelConfig:
    return tiny_config()


def _reduced_retro() -> ModelConfig:
    return tiny_config(depth=2)


register("mt-product", product_config, _reduced_product)
register("mt-retro", retro_config, _reduced_retro)
