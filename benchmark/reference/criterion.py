"""Set criterion (counterpart of ``tce_rvos_tpu/models/criterion.py``): focal
class loss, L1 + GIoU box loss, focal + dice mask loss, the optional
visibility loss, and the same losses for every auxiliary decoder layer
(keys suffixed ``_i``), all already weighted.

Vectorised like the JAX package: the matcher picks one query per clip, and
the valid-frame bookkeeping is a boolean mask, not a Python loop.

In a ``torch.distributed`` world each rank's losses are its part of the
global-batch losses, as the JAX package's one ``jit`` over the sharded
batch computes them: ``num_boxes`` is the count of valid frames summed
over the ranks, then clamped to at least 1 (the JAX package clamps the
global sum; the reference clamps the sum divided by the world size). Every
loss is a sum over this rank's clips divided by ``num_boxes`` or by ``t``
(the visibility loss), neither of which depends on how the batch is split,
so the sum over the ranks of their losses (and gradients) is the
global-batch one (``parallel/train_step.py`` sums them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from .matcher import MatcherConfig, match
from .segmentation import dice_loss, sigmoid_focal_loss
from .boxes import box_cxcywh_to_xyxy, elementwise_giou


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 1
    focal_alpha: float = 0.25
    mask_out_stride: int = 4
    use_masks: bool = True
    use_vis: bool = False
    # loss weights (the reference's weight_dict)
    cls_coef: float = 2.0
    bbox_coef: float = 5.0
    giou_coef: float = 2.0
    mask_coef: float = 2.0
    dice_coef: float = 5.0
    vis_coef: float = 2.0
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)


def _pick(x: torch.Tensor, best_q: torch.Tensor) -> torch.Tensor:
    """x [b, t, q, ...] -> [b, t, ...] at each clip's matched query."""
    idx = best_q.view(-1, 1, 1, *([1] * (x.dim() - 3))).expand(
        x.shape[0], x.shape[1], 1, *x.shape[3:])
    return torch.gather(x, 2, idx)[:, :, 0]


def _one_layer_losses(cfg: CriterionConfig, outputs: Dict[str, torch.Tensor],
                      targets: Dict[str, torch.Tensor], num_boxes: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    logits = outputs["pred_logits"]  # [b, t, q, K]
    boxes = outputs["pred_boxes"]
    masks = outputs["pred_masks"]
    b, t, q, k = logits.shape

    best_q = match(cfg.matcher, logits, boxes, masks, targets["labels"], targets["boxes"],
                   targets["masks"], targets["valid"], outputs.get("pred_visible"))
    valid = targets["valid"].bool()  # [b, t]
    losses: Dict[str, torch.Tensor] = {}

    # ---- class loss: the matched query on valid frames gets the target
    # label (0 when binary), everything else no-object ----
    qa = torch.arange(q, device=logits.device)[None, None, :]
    is_matched = (qa == best_q[:, None, None]) & valid[:, :, None]  # [b, t, q]
    label = 0 if cfg.num_classes == 1 else targets["labels"].long()[:, :, None]
    tgt_cls = torch.where(is_matched, label, cfg.num_classes)
    onehot = F.one_hot(tgt_cls, k + 1)[..., :-1].to(logits.dtype)
    loss_ce = sigmoid_focal_loss(logits.reshape(b, t * q, k), onehot.reshape(b, t * q, k),
                                 num_boxes, alpha=cfg.focal_alpha) * (t * q)
    losses["loss_ce"] = cfg.cls_coef * loss_ce

    # ---- visibility loss ----
    if cfg.use_vis and "pred_visible" in outputs:
        vis_matched = _pick(outputs["pred_visible"], best_q)  # [b, t, 1]
        tgt_vis = valid.to(vis_matched.dtype)[..., None]
        loss_vis = sigmoid_focal_loss(vis_matched, tgt_vis, float(t),
                                      alpha=cfg.focal_alpha) * (t * q)
        losses["loss_vis"] = cfg.vis_coef * loss_vis

    # ---- box losses (all frames, like the reference) ----
    src_boxes = _pick(boxes, best_q).reshape(b * t, 4)
    tgt_boxes = targets["boxes"].reshape(b * t, 4)
    losses["loss_bbox"] = cfg.bbox_coef * ((src_boxes - tgt_boxes).abs().sum() / num_boxes)
    giou = elementwise_giou(box_cxcywh_to_xyxy(src_boxes), box_cxcywh_to_xyxy(tgt_boxes))
    losses["loss_giou"] = cfg.giou_coef * ((1.0 - giou).sum() / num_boxes)

    # ---- mask losses ----
    if cfg.use_masks:
        s = cfg.mask_out_stride
        start = s // 2
        tm = targets["masks"][:, :, start::s, start::s].to(masks.dtype)
        src_flat = _pick(masks, best_q).reshape(b, -1)  # [b, t*h*w]
        tgt_flat = tm.reshape(b, -1)
        losses["loss_mask"] = cfg.mask_coef * sigmoid_focal_loss(src_flat, tgt_flat, num_boxes)
        losses["loss_dice"] = cfg.dice_coef * dice_loss(src_flat, tgt_flat, num_boxes)
    return losses


def global_num_boxes(valid: torch.Tensor) -> torch.Tensor:
    """The count of valid frames over every rank's batch, at least 1."""
    return valid.sum().float().clamp(min=1.0)


def criterion(cfg: CriterionConfig, outputs: Dict, targets: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """All losses, weighted. ``targets``: labels [b, t] int, boxes [b, t, 4]
    cxcywh normalised, masks [b, t, H, W] binary at the padded input size,
    valid [b, t] {0, 1}. The total is the sum of the values, the auxiliary
    layers' losses (``aux_outputs``) included as ``<name>_<i>``."""
    num_boxes = global_num_boxes(targets["valid"])
    losses = _one_layer_losses(cfg, outputs, targets, num_boxes)
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        aux_losses = _one_layer_losses(cfg, aux, targets, num_boxes)
        losses.update({f"{k}_{i}": v for k, v in aux_losses.items()})
    return losses


def criterion_from_configs(model_cfg, train_cfg) -> CriterionConfig:
    """From the port's ModelConfig and TrainConfig, as the JAX package's
    function: the class count (``num_classes``), the mask losses and costs
    (``masks``) and the visibility loss and cost (``vis_loss``) from the
    model's config, the weights from the training config."""
    return CriterionConfig(
        num_classes=model_cfg.num_classes,
        focal_alpha=train_cfg.focal_alpha,
        use_masks=model_cfg.masks,
        use_vis=model_cfg.vis_loss,
        cls_coef=train_cfg.cls_loss_coef,
        bbox_coef=train_cfg.bbox_loss_coef,
        giou_coef=train_cfg.giou_loss_coef,
        mask_coef=train_cfg.mask_loss_coef,
        dice_coef=train_cfg.dice_loss_coef,
        vis_coef=train_cfg.vis_loss_coef,
        matcher=MatcherConfig(
            cost_class=train_cfg.set_cost_class,
            cost_bbox=train_cfg.set_cost_bbox,
            cost_giou=train_cfg.set_cost_giou,
            cost_mask=train_cfg.set_cost_mask,
            cost_dice=train_cfg.set_cost_dice,
            cost_vis=train_cfg.set_cost_vis,
            num_classes=model_cfg.num_classes,
            use_masks=model_cfg.masks,
            use_vis=model_cfg.vis_loss,
        ),
    )
