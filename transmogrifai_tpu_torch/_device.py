"""Device resolution for every entry point of the port.

The port runs on the card unless the caller asks for the CPU: with no
argument, :func:`resolve_device` returns ``cuda`` and raises when CUDA
is absent — it never falls back to the CPU, so a serving process that
lost its card fails loudly instead of scoring on the host. Tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises RuntimeError without CUDA); anything
    else -> ``torch.device(device)``. A CUDA device asked for explicitly
    must exist too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "transmogrifai_tpu_torch: CUDA is not available; pass "
            "device='cpu' to run on the host")
    return dev
