"""Hand-written Hopper kernels of the port, one package per TPU kernel it
replaces (``<name>/{kernel,ops,ref}.py`` as in ``repro.kernels``; CUDA
sources in ``repro_torch/csrc``). ``ops`` is the public wrapper: the plain
``ref`` version for CPU tensors, the kernel for CUDA tensors."""

from repro_torch.kernels._build import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_gqa.ops import (decode_gqa_attention,
                                               paged_decode_gqa_attention)
from repro_torch.kernels.draft_verify.ops import draft_verify
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bshd)

__all__ = ["decode_gqa_attention", "draft_verify", "flash_attention",
           "flash_attention_bshd", "launch_counts",
           "paged_decode_gqa_attention", "reset_launch_counts"]
