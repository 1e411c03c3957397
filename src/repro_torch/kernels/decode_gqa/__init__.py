from repro_torch.kernels.decode_gqa.ops import (decode_gqa_attention,
                                               paged_decode_gqa_attention)
__all__ = ["decode_gqa_attention", "paged_decode_gqa_attention"]
