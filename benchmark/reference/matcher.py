"""Min-cost instance matcher (counterpart of ``tce_rvos_tpu/models/matcher.py``).

Each clip has one ground-truth instance track, so matching is an argmin
over the query slots, not a Hungarian solve. Cost per batch element:
  * class cost: focal pos-neg margin at the target class, averaged over
    valid frames only;
  * box costs: L1 + GIoU, averaged over valid frames only;
  * mask costs: focal + dice over ALL frames (the reference does not mask
    invalid frames here);
  * visibility cost (optional): focal margin over all frames.

Returns the argmin query index per batch element: [b] int64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .segmentation import sigmoid_ce
from .boxes import box_cxcywh_to_xyxy, generalized_box_iou


def _focal_margin(prob: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0):
    """pos_cost - neg_cost of the focal classification cost."""
    neg = (1 - alpha) * (prob ** gamma) * (-torch.log(1 - prob + 1e-8))
    pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    return pos - neg


def _focal_mask_coef(logits, targets, alpha=0.25, gamma=2.0):
    """Elementwise sigmoid focal coefficient; logits and targets broadcast."""
    prob = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    coef = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        coef = (alpha * targets + (1 - alpha) * (1 - targets)) * coef
    return coef


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    cost_mask: float = 2.0
    cost_dice: float = 5.0
    cost_vis: float = 2.0
    num_classes: int = 1
    use_masks: bool = True
    use_vis: bool = False
    mask_out_stride: int = 4


@torch.no_grad()
def match(*args, **kwargs) -> torch.Tensor:
    """The argmin query index per batch element: [b] int64."""
    return torch.argmin(match_costs(*args, **kwargs), dim=1)


@torch.no_grad()
def match_costs(
    cfg: MatcherConfig,
    pred_logits: torch.Tensor,   # [b, t, q, K]
    pred_boxes: torch.Tensor,    # [b, t, q, 4] cxcywh in [0, 1]
    pred_masks: torch.Tensor,    # [b, t, q, h, w] logits (stride 4)
    tgt_labels: torch.Tensor,    # [b, t] int
    tgt_boxes: torch.Tensor,     # [b, t, 4]
    tgt_masks: torch.Tensor,     # [b, t, H, W] binary, H = 4h (padded input size)
    tgt_valid: torch.Tensor,     # [b, t] {0, 1}
    pred_visible: Optional[torch.Tensor] = None,  # [b, t, q, 1]
) -> torch.Tensor:
    b, t, q, _ = pred_logits.shape
    valid = tgt_valid.float()
    n_valid = valid.sum(1).clamp(min=1.0)  # [b]
    any_valid = (valid.sum(1) > 0)[:, None]

    cost = torch.zeros((b, q), dtype=torch.float32, device=pred_logits.device)

    # ---- class cost (valid frames only) ----
    prob = torch.sigmoid(pred_logits)
    if cfg.num_classes == 1:
        prob_tgt = prob[..., 0]
    else:
        idx = tgt_labels.long()[:, :, None, None].expand(b, t, q, 1)
        prob_tgt = torch.gather(prob, -1, idx)[..., 0]
    cls = (_focal_margin(prob_tgt) * valid[:, :, None]).sum(1) / n_valid[:, None]
    cost = cost + cfg.cost_class * torch.where(any_valid, cls, torch.zeros_like(cls))

    # ---- box costs (valid frames only) ----
    l1 = (pred_boxes - tgt_boxes[:, :, None, :]).abs().sum(-1)  # [b, t, q]
    giou = generalized_box_iou(
        box_cxcywh_to_xyxy(pred_boxes.reshape(b * t, q, 4)),
        box_cxcywh_to_xyxy(tgt_boxes.reshape(b * t, 1, 4)),
    ).reshape(b, t, q)
    box_cost = cfg.cost_bbox * l1 + cfg.cost_giou * (-giou)
    box_cost = (box_cost * valid[:, :, None]).sum(1) / n_valid[:, None]
    cost = cost + torch.where(any_valid, box_cost, torch.zeros_like(box_cost))

    # ---- visibility cost (all frames) ----
    if cfg.use_vis and pred_visible is not None:
        cost = cost + cfg.cost_vis * _focal_margin(torch.sigmoid(pred_visible[..., 0])).mean(1)

    # ---- mask costs (all frames, as in the reference) ----
    if cfg.use_masks:
        s = cfg.mask_out_stride
        start = s // 2
        tm = tgt_masks[:, :, start::s, start::s].to(pred_masks.dtype)  # [b, t, h, w]
        focal = _focal_mask_coef(pred_masks, tm[:, :, None])
        focal = focal.transpose(1, 2).reshape(b, q, -1).mean(-1)
        pm = torch.sigmoid(pred_masks).transpose(1, 2).reshape(b, q, -1)
        tmf = tm.reshape(b, 1, -1)
        num = 2.0 * (pm * tmf).sum(-1)
        den = pm.sum(-1) + tmf.sum(-1)
        dice = (num + 1.0) / (den + 1.0)
        cost = cost + cfg.cost_mask * focal + cfg.cost_dice * (-dice)

    return cost  # [b, q]
