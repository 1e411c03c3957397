"""Model configuration dataclasses + registry: an own copy of
``repro.configs.base`` (the port imports nothing of the JAX package).

The Molecular Transformer (``configs/mt.py``), the dense decoder-only
architectures (``configs/{smollm_135m,qwen3_8b,starcoder2_15b,
command_r_35b}.py``), the MoE ones (``phi35_moe_42b``,
``llama4_maverick_400b``), the recurrent ones (``jamba_v01_52b``: Mamba +
attention + MoE; ``rwkv6_1p6b``), the VLM (``llama32_vision_11b``: gated
cross-attention to a frontend memory) and the audio encoder
(``hubert_xlarge``: bidirectional, frame embeddings in) use these
fields.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden width
    capacity_factor: float = 1.25
    shared_expert: bool = False    # Llama-4-style always-on shared expert
    router_z_loss: float = 1e-3
    aux_loss_weight: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64             # RWKV6 head size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio|seq2seq
    n_layers: int                  # decoder depth
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False          # Qwen3-style per-head RMSNorm on q/k
    use_bias: bool = False
    gated_ffn: bool = True         # SwiGLU vs plain GELU
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    # rope | sinusoidal | none; "" = the family's own (the MT's sinusoidal
    # table, RoPE otherwise), so a seq2seq config built without it stays
    # the MT
    pos: str = ""
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    causal: bool = True

    # repeating layer-block pattern, tiled to n_layers: "attn"
    # (self-attention + FFN), "xattn" (gated cross-attention to the
    # frontend memory + FFN), "mamba" (Mamba mixer + FFN), "rwkv" (RWKV6
    # time-mix + channel-mix)
    layer_pattern: tuple[str, ...] = ("attn",)
    # FFN kind per pattern position: "dense" | "moe"
    ffn_pattern: tuple[str, ...] = ("dense",)

    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None

    # 0 = full attention; > 0 = sliding-window length for decode
    sliding_window: int = 0

    # VLM / audio frontend stub: memory tokens and their width
    memory_tokens: int = 0
    memory_dim: int = 0

    n_encoder_layers: int = 0      # seq2seq: encoder depth
    max_len: int = 1024            # positional table length

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.pos:
            object.__setattr__(self, "pos", "sinusoidal"
                               if self.family == "seq2seq" else "rope")
        assert self.n_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"pattern length {len(self.layer_pattern)}")
        assert len(self.ffn_pattern) == len(self.layer_pattern)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


# ---------------------------------------------------------------------------
# registry: every architecture of the JAX package's

_REGISTRY: dict[str, tuple[Callable[[], ModelConfig],
                           Callable[[], ModelConfig]]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]) -> None:
    _REGISTRY[arch_id] = (full, reduced)


def get_config(arch_id: str, *, reduced: bool = False) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have "
                       f"{sorted(_REGISTRY)}")
    full, red = _REGISTRY[arch_id]
    return red() if reduced else full()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
