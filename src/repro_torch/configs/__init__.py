from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mt import (product_config, retro_config, tiny_config,
                                    with_vocab)

__all__ = ["ModelConfig", "product_config", "retro_config", "tiny_config",
           "with_vocab"]
