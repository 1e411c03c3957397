"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
— Finch, data-dependent decay. [arXiv:2404.05892]

Attention-free: the ``rwkv`` block pairs time-mix (data-dependent-decay WKV
state) with channel-mix (squared-relu FFN of width d_ff). n_heads/n_kv_heads
are nominal (d_model / rwkv.head_dim = 32 WKV heads of size 64). Decode state
is O(1) in sequence length, so long_500k runs natively (no sliding window).
"""

from repro_torch.configs.base import ModelConfig, RWKVConfig, register


def CONFIG() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab_size=65536,
        use_bias=False, norm="layernorm", gated_ffn=False, pos="none",
        layer_pattern=("rwkv",), ffn_pattern=("dense",),
        rwkv=RWKVConfig(head_dim=64),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-reduced", family="ssm",
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        use_bias=False, norm="layernorm", gated_ffn=False, pos="none",
        layer_pattern=("rwkv",), ffn_pattern=("dense",),
        rwkv=RWKVConfig(head_dim=64),
    )


register("rwkv6-1.6b", CONFIG, reduced)
