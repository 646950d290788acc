"""Where the port runs: every entry point takes ``device=None`` for the
card."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card.  A CUDA device without CUDA raises — no
    entry point quietly continues on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device
