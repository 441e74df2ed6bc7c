"""Device selection shared by the port's entry points.

Entry points (``build_model``, ``InstSegServer``, the hand-kernel wrappers)
run on the card unless the caller asks for the host: the default device is
``"cuda"``, and a machine without CUDA raises instead of silently falling
back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is available (pass ``device="cpu"`` to run on the host)."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the host")
    return d
