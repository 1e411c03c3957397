"""Model configuration: the ``ModelConfig`` fields the Molecular Transformer
uses, an own copy of ``repro.configs.base.ModelConfig`` restricted to them
(the port imports nothing of the JAX package). The MT's positional encoding
is sinusoidal and its attention spans the whole cache, so the JAX fields
``pos`` and ``sliding_window`` have one value here and are left out."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # "seq2seq" (the only family ported so far)
    n_layers: int                  # decoder depth
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 -> d_model // n_heads
    use_bias: bool = False
    gated_ffn: bool = True         # SwiGLU vs plain GELU
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    n_encoder_layers: int = 0
    max_len: int = 1024            # positional table length

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads
