"""Configuration of the port: its own copy of the architecture fields of
``tce_rvos_tpu/config.py::ModelConfig`` that the ported paths read, and of
``TrainConfig`` and ``DataConfig``, with the same names and defaults, and
``flagship_config``.

``msda_impl`` is gone: the device decides (the CUDA kernels on the card, the
plain version on the CPU). ``compute_dtype`` stays: "bfloat16" casts the
weights and the video at the boundary, as in the JAX package (once in the
inference engine; inside the loss, over f32 master weights, in training).

What the port supports of the rest is fixed, not configurable: a ResNet-50
backbone without DC5, the V-L blocks of the FPN, relative coordinates in
the dynamic mask head, mask losses, and one class logit (``--binary``). The
options not ported yet (the other backbones, DC5, ``vis_loss``,
``contrastive``, ``f_token < 0``, the non-binary class counts) come with
their code and a parity test against the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

NUM_CLASSES = 1  # --binary: one "is referred" logit per query


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (the JAX package's names and defaults)."""

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
    mask_dim: int = 256
    controller_layers: int = 3
    dynamic_mask_channels: int = 8

    # Losses wired into the architecture
    aux_loss: bool = True

    # TCE variants
    qtrans: bool = False                  # IQT
    f_token: int = 0                      # FTF: > 0 learnable frame tokens
    msda_3d: bool = False                 # temporal MSDA in encoder and decoder

    # context frames on both sides of an inference window, outputs dropped
    # (defined here; the reference reads it but never defines it)
    f_extra: int = 0

    compute_dtype: str = "float32"        # "bfloat16" for the fast path


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and loss weights: the fields of
    ``tce_rvos_tpu/config.py::TrainConfig`` with their names and defaults,
    except ``flat_opt`` and ``dropout_rng_impl``, which choose TPU-specific
    implementations (a fused flat AdamW, the TPU's hardware RNG) and have
    no counterpart here: the port uses ``torch.optim.AdamW`` and torch's
    generator, seeded from ``seed``."""

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

    seed: int = 42


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths and sampling options (reference: opts.py:108-132,
    147-152), the JAX package's fields and defaults."""

    dataset_file: str = "ytvos"
    coco_path: str = "data/coco"
    ytvos_path: str = "data/Refer_YouTube_VOS/rvos"
    mevis_path: str = "data/MeViS"
    davis_path: str = "/data/davis17"
    a2d_path: str = "/data/a2d_sentences"
    jhmdb_path: str = "data/jhmdb_sentences"
    max_skip: int = 3
    max_size: int = 640
    remove_difficult: bool = False
    num_workers: int = 4
    keep_fps: bool = False
    vid_aug: bool = False
    pretrain_enc: bool = False
    pretrain_coco: bool = False
    # per-node dataset sharding (reference --cache_mode +
    # NodeDistributedSampler, datasets/samplers.py:75-139)
    cache_mode: bool = False


def flagship_config(**overrides) -> ModelConfig:
    """The flagship configuration: --with_box_refine --binary --f_token 8
    --qtrans (``--binary`` is the port's only class head)."""
    base = dict(with_box_refine=True, f_token=8, qtrans=True)
    base.update(overrides)
    return ModelConfig(**base)
