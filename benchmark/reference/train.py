"""The plain training step: float32 forward (TF32 off), the criterion with
its matcher, backward, the global-norm clip and AdamW with decoupled
weight decay, per parameter, with the trainer's LR tiers by parameter
name (base, ``backbone.0``, ``text_encoder``, and ``reference_points`` /
``sampling_offsets`` at ``lr * lr_linear_proj_mult``). The schedule stays
at its first value for the steps this reference follows."""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from .config import TrainConfig
from .criterion import criterion, criterion_from_configs

B1, B2, EPS = 0.9, 0.999, 1e-8


def tier_lr(name: str, cfg: TrainConfig) -> float:
    if any(k in name for k in cfg.lr_text_encoder_names):
        return cfg.lr_text_encoder
    if any(k in name for k in cfg.lr_backbone_names):
        return cfg.lr_backbone
    if any(k in name for k in cfg.lr_linear_proj_names):
        return cfg.lr * cfg.lr_linear_proj_mult
    return cfg.lr


def to_device(batch: Mapping, device) -> Dict:
    out = {}
    for k, v in batch.items():
        if isinstance(v, Mapping):
            out[k] = to_device(v, device)
            continue
        t = torch.as_tensor(v)
        if not (t.is_floating_point() or t.dtype == torch.bool):
            t = t.long()
        out[k] = t.to(device)
    return out


class PlainAdamW:
    """AdamW over the model's named parameters, in float32."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig):
        self.cfg = cfg
        self.params = dict(model.named_parameters())
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update; returns each parameter's clipped gradient, as the
        update takes it."""
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = 1.0 if gnorm < self.cfg.clip_max_norm else self.cfg.clip_max_norm / gnorm
        self.count += 1
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        clipped = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.mu[k].mul_(B1).add_(g * (1 - B1))
            self.nu[k].mul_(B2).add_(g * g * (1 - B2))
            adam = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + EPS)
            lr = tier_lr(k, self.cfg)
            p.mul_(1 - lr * self.cfg.weight_decay).sub_(adam * lr)
        return clipped


def follow_steps(model: torch.nn.Module, model_cfg, train_cfg: TrainConfig,
                 batches: List[Mapping], forward=None) -> Tuple[List[float], Dict[str, float],
                                                                Dict[str, float], List[Dict]]:
    """Runs len(batches) training steps of ``model`` (train mode) from its
    weights. Returns each step's total loss, the norm of each parameter's
    first (clipped) gradient, the norm of each parameter's change over all
    the steps, and each step's weighted loss terms. ``forward(model, batch)``
    replaces the model call (the control computes it in another
    precision)."""
    device = next(model.parameters()).device
    crit = criterion_from_configs(model_cfg, train_cfg)
    opt = PlainAdamW(model, train_cfg)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    model.train()
    losses, terms, first = [], [], None
    for i, batch in enumerate(batches):
        b = to_device(batch, device)
        kwargs = dict(video_mask=b["video_mask"], text_ids=b["text_ids"],
                      text_attn_mask=b["text_attn_mask"], sizes=b["sizes"],
                      aux_outputs=model_cfg.aux_loss)
        for p in model.parameters():
            p.grad = None
        out = (forward or (lambda m, v, kw: m(v, **kw)))(model, b["video"], kwargs)
        out = _float(out)
        parts = criterion(crit, out, b["targets"])
        total = sum(parts.values())
        total.backward()
        losses.append(float(total.detach()))
        terms.append({k: float(v.detach()) for k, v in parts.items()})
        clipped = opt.step()
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(g.double())) for k, g in clipped.items()}
    change = {k: float(torch.linalg.vector_norm((p.detach() - start[k]).double()))
              for k, p in model.named_parameters()}
    return losses, first, change, terms


def _float(x):
    if torch.is_tensor(x):
        return x.float() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _float(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_float(v) for v in x)
    return x
