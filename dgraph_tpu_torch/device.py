"""The device probe shared by the dispatcher and the vector index.

Every entry point of the port is bound to one torch device: `cuda` by
default, `cpu` where the caller asks for the host (as the tests do).
Asking for CUDA where there is none raises; there is no silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """A torch device for an entry point; CUDA must be present when asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' asked for, but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
