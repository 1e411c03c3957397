"""Configs the port serves: the Molecular Transformer (``mt``) and the
dense decoder-only architectures, registered by arch id
(``get_config(arch_id, reduced=...)`` / ``list_archs()``)."""

from repro_torch.configs import (  # noqa: F401  (registration)
    command_r_35b, qwen3_8b, smollm_135m, starcoder2_15b)
from repro_torch.configs.base import (ModelConfig, get_config, list_archs,
                                      register)
from repro_torch.configs.mt import (product_config, retro_config, tiny_config,
                                    with_vocab)

__all__ = ["ModelConfig", "get_config", "list_archs", "register",
           "product_config", "retro_config", "tiny_config", "with_vocab"]
