"""Device choice for the port's entry points (the GPU unless the caller
asks for the CPU), and the process's rank."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; raises if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def process_rank() -> int:
    """This process's rank in ``torch.distributed``, 0 outside it."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
