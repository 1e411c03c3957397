"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; this package imports nothing
of it. The first slice is the Molecular Transformer's one-shot serving path
(``repro_torch.serving.ReactionEngine``, all four decode modes), with the
cached self-attention (``decode_gqa``) and the speculative accept op
(``draft_verify``) as hand-written CUDA kernels (``repro_torch/csrc``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
