"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. A CUDA device without a card is an error,
    never a silent fall-back to the CPU; the CPU runs only when asked for
    (the tests pass ``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    return dev


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` in one copy. To a card the copy goes
    through pinned memory and does not block the host: it is queued on the
    current stream, and the caching host allocator keeps the pinned block
    until it has run. On the CPU the tensor shares ``a``'s memory."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
