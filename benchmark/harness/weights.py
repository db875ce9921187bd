"""The weights of a run, made by the benchmark from the seed and handed to
the port and to the reference alike: the reference model's own
initialisation, then N(0, 0.02) noise on every parameter (so that MSDA's
offsets and weights depend on the query), drawn on the device from a
generator seeded by the run's seed. Kept on the host in float32."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

import reference

from .traffic import torch_generator


def state_dict(cfg: Mapping, seed: int, device) -> Tuple[Dict[str, torch.Tensor], int]:
    """(the state dict on the host, the number of parameter elements)."""
    model = reference.build(cfg, device)
    g = torch_generator(seed, 0, device)
    reference.init_weights(model, g)
    with torch.no_grad():
        params = list(model.parameters())
        noise = torch.randn(sum(p.numel() for p in params), generator=g, device=device)
        at = 0
        for p in params:
            p.add_(noise[at:at + p.numel()].view_as(p), alpha=0.02)
            at += p.numel()
    sd = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    return sd, sum(p.numel() for p in params)
