"""Model factory (counterpart of ``tce_rvos_tpu/models/build.py``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.models.referformer import ReferFormer, init_weights
from tce_rvos_tpu_torch.utils.device import resolve_device


def build_model(
    cfg: ModelConfig,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
) -> ReferFormer:
    """The model in eval mode on ``device`` (``cuda`` by default) with
    seeded random weights, drawn on the CPU so every device gets the same
    ones."""
    device = resolve_device(device)
    model = ReferFormer(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
