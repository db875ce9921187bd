"""Frozen reference copy of the port's ``ModelConfig`` and ``TrainConfig``
(the architecture fields and the trainer's optimizer, schedule and loss
settings, with their names and defaults). ``binary`` and ``dataset_file``
give the class heads' width; ``masks`` adds the mask losses and costs;
``vlblock`` keeps the FPN's V-L blocks; ``f_token`` > 0 is FTF's frame
tokens, < 0 LastLayerAsToken."""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _num_classes_for(dataset_file: str, binary: bool) -> int:
    """The class heads' width (the JAX package's ``_num_classes_for``)."""
    if binary:
        return 1
    if dataset_file == "ytvos":
        return 65
    if dataset_file == "davis":
        return 78
    if dataset_file in ("a2d", "jhmdb"):
        return 1
    return 91  # coco, refcoco(+/g)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (the JAX package's names and defaults)."""

    backbone: str = "resnet50"
    dilation: bool = False                # DC5: ResNet's layer4 at stride 1, dilation 2
    use_checkpoint: bool = False          # recompute each enc/dec layer in backward
    num_feature_levels: int = 4

    # Transformer
    enc_layers: int = 4
    dec_layers: int = 4
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    dropout: float = 0.1
    nheads: int = 8
    num_frames: int = 5
    num_queries: int = 5
    dec_n_points: int = 4
    enc_n_points: int = 4
    with_box_refine: bool = False

    # Text encoder (defaults = roberta-base)
    freeze_text_encoder: bool = False
    text_encoder_layers: int = 12
    text_encoder_hidden: int = 768
    text_encoder_heads: int = 12
    text_encoder_intermediate: int = 3072

    # Segmentation
    masks: bool = True                    # mask losses and mask matching costs
    mask_dim: int = 256
    controller_layers: int = 3
    dynamic_mask_channels: int = 8
    rel_coord: bool = True                # relative coordinates into the mask head

    # Losses wired into the architecture
    aux_loss: bool = True
    vis_loss: bool = False                # visibility heads and loss
    contrastive: bool = False             # cosine of mean memory and sentence

    # TCE variants
    qtrans: bool = False                  # IQT
    f_token: int = 0                      # FTF: > 0 frame tokens; < 0 LastLayerAsToken
    vlblock: bool = True                  # V-L blocks in the FPN
    msda_3d: bool = False                 # temporal MSDA in encoder and decoder

    # Dataset-derived
    dataset_file: str = "ytvos"
    binary: bool = False

    # context frames on both sides of an inference window, outputs dropped
    # (defined here; the reference reads it but never defines it)
    f_extra: int = 0

    compute_dtype: str = "float32"        # "bfloat16" for the fast path

    @property
    def num_classes(self) -> int:
        return _num_classes_for(self.dataset_file, self.binary)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and loss weights: the fields of
    ``tce_rvos_tpu/config.py::TrainConfig`` with their names and defaults,
    except ``dropout_rng_impl``, which chooses the TPU's hardware RNG and
    has no counterpart here: the port draws dropout from torch's
    generator, seeded from ``seed``. ``flat_opt`` (default True) trains
    with the fused flat AdamW (``parallel/flat_adamw.py``), False with
    ``torch.optim.AdamW`` over one group per tier: the same update."""

    lr: float = 1e-4
    lr_backbone: float = 2e-5
    lr_backbone_names: Tuple[str, ...] = ("backbone.0",)
    lr_text_encoder: float = 1e-5
    lr_text_encoder_names: Tuple[str, ...] = ("text_encoder",)
    lr_linear_proj_names: Tuple[str, ...] = ("reference_points", "sampling_offsets")
    lr_linear_proj_mult: float = 1.0
    batch_size: int = 1
    weight_decay: float = 5e-4
    epochs: int = 10
    lr_drop: Tuple[int, ...] = (6, 8)
    clip_max_norm: float = 0.1

    # Matcher costs
    set_cost_class: float = 2.0
    set_cost_vis: float = 2.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0
    set_cost_mask: float = 2.0
    set_cost_dice: float = 5.0

    # Loss coefficients
    mask_loss_coef: float = 2.0
    dice_loss_coef: float = 5.0
    cls_loss_coef: float = 2.0
    vis_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    eos_coef: float = 0.1
    focal_alpha: float = 0.25

    # --pretrain_enc: freeze everything except the deformable encoder
    pretrain_enc: bool = False
    # triangular CyclicLR between the two boundaries (the keep_fps protocol)
    cyclic_lr: bool = False
    cyclic_lr_boundary: Tuple[float, float] = (1e-5, 1e-4)

    # mirror of ModelConfig.freeze_text_encoder for the optimizer: a frozen
    # text encoder gets no parameter group, so no update and no weight decay
    freeze_text_encoder: bool = False

    # the fused flat AdamW (parallel/flat_adamw.py): one flat parameter and
    # gradient buffer, one norm and one update kernel a step; False runs
    # torch.optim.AdamW over one group per tier (the same update)
    flat_opt: bool = True

    seed: int = 42
