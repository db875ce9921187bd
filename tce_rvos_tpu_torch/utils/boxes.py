"""Box utilities the serving path uses (counterpart of
``tce_rvos_tpu/utils/boxes.py``; the matcher's box ops come with training)."""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """logit with the reference's clamping."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)
