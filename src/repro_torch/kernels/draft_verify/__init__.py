from repro_torch.kernels.draft_verify.ops import draft_verify
__all__ = ["draft_verify"]
