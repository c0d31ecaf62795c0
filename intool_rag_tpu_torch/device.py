"""Device selection (counterpart of ``intool_rag_tpu/backend.py``).

Unlike the JAX package, which degrades to the CPU when its accelerator is
missing, the port never falls back: asking for CUDA without a card raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA. Raises when a CUDA device is requested but
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass device='cpu' explicitly"
        )
    return dev
