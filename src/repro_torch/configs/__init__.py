"""The port's configs, registered by arch id (``get_config(arch_id,
reduced=...)`` / ``list_archs()``): the Molecular Transformer (``mt``:
mt-product, mt-retro), the decoder-only architectures (dense, MoE, Mamba
hybrid, RWKV, the cross-attention VLM) and the audio encoder; the JAX
package's twelve."""

from repro_torch.configs import (  # noqa: F401  (registration)
    command_r_35b, hubert_xlarge, jamba_v01_52b, llama4_maverick_400b,
    llama32_vision_11b, mt, phi35_moe_42b, qwen3_8b, rwkv6_1p6b,
    smollm_135m, starcoder2_15b)
from repro_torch.configs.base import (MambaConfig, ModelConfig, MoEConfig,
                                      RWKVConfig, get_config, list_archs,
                                      register)
from repro_torch.configs.mt import (product_config, retro_config, tiny_config,
                                    with_vocab)

__all__ = ["MambaConfig", "ModelConfig", "MoEConfig", "RWKVConfig",
           "get_config", "list_archs", "register", "product_config",
           "retro_config", "tiny_config", "with_vocab"]
