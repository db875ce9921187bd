"""The command line's flags (the port's copy of ``tce_rvos_tpu/cli.py``):
the model, training and data flags and their configs.

Every flag keeps the reference's name and default, ``--vlblock`` included,
which keeps the reference's inverted store_false meaning (passing it turns
the V-L FPN blocks off). Every model option the JAX model runs is accepted:
no ``--binary`` (the dataset's class heads), ``--f_token -1``
(LastLayerAsToken), ``--vis_loss``, ``--contrastive``, ``--vlblock``,
``--no_rel_coord``. ``--masks`` (default off, as in the JAX command line)
adds the mask losses and matching costs to training and the mask stats to
``--eval`` on RefCOCO(+/g). A flag set to a value neither package runs
raises and names the flag: ``--two_stage`` (the JAX model refuses it),
``--position_embedding learned`` (the JAX model reads no such field and
would run sine in silence) and ``--msda_impl`` other than ``auto``.
``--pre_norm`` and ``--backbone_pretrained`` change nothing at inference in
either package and are accepted as they are.

The training and data flags keep the JAX package's names and defaults too.
``--flat_opt`` (the default) trains with the fused flat AdamW
(``parallel/flat_adamw.py``: flat parameter and gradient buffers, one
update kernel a step), ``--no-flat_opt`` with ``torch.optim.AdamW`` over
one group per tier: the same update, as in the JAX package, whose
checkpoints of one cannot resume the other. ``--dropout_rng_impl`` chooses
a TPU RNG of the same dropout distribution; the port accepts every value
and draws from torch's generator. ``--ckpt_backend orbax`` selects the retained checkpoint manager
(``utils/native_ckpt.py::CheckpointManager``), ``msgpack`` the plain
checkpoint directories. ``--device`` (default ``cuda``) is the port's own.
"""

from __future__ import annotations

import argparse

from tce_rvos_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from tce_rvos_tpu_torch.models.referformer import check_backbone


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--with_box_refine", action="store_true")
    p.add_argument("--two_stage", action="store_true")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--backbone_pretrained", default=None)
    p.add_argument("--use_checkpoint", action="store_true")
    p.add_argument("--dilation", action="store_true")
    p.add_argument("--position_embedding", default="sine", choices=("sine", "learned"))
    p.add_argument("--num_feature_levels", default=4, type=int)
    p.add_argument("--enc_layers", default=4, type=int)
    p.add_argument("--dec_layers", default=4, type=int)
    p.add_argument("--dim_feedforward", default=2048, type=int)
    p.add_argument("--hidden_dim", default=256, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--nheads", default=8, type=int)
    p.add_argument("--num_frames", default=5, type=int)
    p.add_argument("--num_queries", default=5, type=int)
    p.add_argument("--dec_n_points", default=4, type=int)
    p.add_argument("--enc_n_points", default=4, type=int)
    p.add_argument("--pre_norm", action="store_true")
    p.add_argument("--freeze_text_encoder", action="store_true")
    p.add_argument("--masks", action="store_true")
    p.add_argument("--mask_dim", default=256, type=int)
    p.add_argument("--controller_layers", default=3, type=int)
    p.add_argument("--dynamic_mask_channels", default=8, type=int)
    p.add_argument("--no_rel_coord", dest="rel_coord", action="store_false")
    p.add_argument("--no_aux_loss", dest="aux_loss", action="store_false")
    p.add_argument("--vis_loss", action="store_true")
    p.add_argument("--contrastive", action="store_true")
    p.add_argument("--binary", action="store_true")
    p.add_argument("--qtrans", action="store_true")
    p.add_argument("--f_token", default=0, type=int)
    p.add_argument("--vlblock", action="store_false",
                   help="(reference semantics) pass to DISABLE the V-L FPN blocks")
    p.add_argument("--f_extra", default=0, type=int)
    p.add_argument("--msda_impl", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="only 'auto': the device picks the MSDA implementation "
                        "(the CUDA kernels on a GPU, the plain version on the CPU)")
    p.add_argument("--msda_3d", action="store_true",
                   help="temporal-trilinear deformable sampling in encoder/decoder")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="inference compute dtype (weights and video are cast "
                        "at the boundary)")
    return p


# flag -> (its value the port does not run, what it runs)
_UNSUPPORTED = (
    ("--two_stage", lambda a: a.two_stage, "single stage, as the JAX model"),
    ("--position_embedding", lambda a: a.position_embedding != "sine",
     "sine only: the JAX model reads no such field and always runs sine"),
    ("--msda_impl", lambda a: a.msda_impl != "auto",
     "auto only: the device picks the MSDA implementation"),
)


def model_config_from_args(args) -> ModelConfig:
    """The port's ``ModelConfig`` from parsed ``add_model_args`` flags;
    raises ``ValueError`` naming the first flag whose value it cannot run,
    an unknown ``--backbone`` (listing the known ones) and ``--dilation``
    on a backbone that is not a ResNet."""
    for flag, unsupported, supported in _UNSUPPORTED:
        if unsupported(args):
            raise ValueError(f"{flag}: not supported by the PyTorch port ({supported})")
    fields = {f.name for f in ModelConfig.__dataclass_fields__.values()}
    cfg = ModelConfig(**{k: v for k, v in vars(args).items() if k in fields})
    check_backbone(cfg)
    return cfg


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr_backbone", default=2e-5, type=float)
    p.add_argument("--lr_backbone_names", default=["backbone.0"], nargs="+")
    p.add_argument("--lr_text_encoder", default=1e-5, type=float)
    p.add_argument("--lr_text_encoder_names", default=["text_encoder"], nargs="+")
    p.add_argument("--lr_linear_proj_names",
                   default=["reference_points", "sampling_offsets"], nargs="+")
    p.add_argument("--lr_linear_proj_mult", default=1.0, type=float)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--lr_drop", default=[6, 8], type=int, nargs="+")
    p.add_argument("--clip_max_norm", default=0.1, type=float)
    p.add_argument("--set_cost_class", default=2, type=float)
    p.add_argument("--set_cost_vis", default=2, type=float)
    p.add_argument("--set_cost_bbox", default=5, type=float)
    p.add_argument("--set_cost_giou", default=2, type=float)
    p.add_argument("--set_cost_mask", default=2, type=float)
    p.add_argument("--set_cost_dice", default=5, type=float)
    p.add_argument("--mask_loss_coef", default=2, type=float)
    p.add_argument("--dice_loss_coef", default=5, type=float)
    p.add_argument("--cls_loss_coef", default=2, type=float)
    p.add_argument("--vis_loss_coef", default=2, type=float)
    p.add_argument("--bbox_loss_coef", default=5, type=float)
    p.add_argument("--giou_loss_coef", default=2, type=float)
    p.add_argument("--eos_coef", default=0.1, type=float)
    p.add_argument("--focal_alpha", default=0.25, type=float)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--pretrained_weights", default=None)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--eval", action="store_true",
                   help="score the val split (jhmdb, refcoco, refcoco+, refcocog) "
                        "instead of training")
    p.add_argument("--num_workers", default=4, type=int)
    return p


def add_data_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset_file", default="ytvos")
    p.add_argument("--coco_path", default="data/coco")
    p.add_argument("--ytvos_path", default="data/Refer_YouTube_VOS/rvos")
    p.add_argument("--mevis_path", default="data/MeViS")
    p.add_argument("--davis_path", default="/data/davis17")
    p.add_argument("--a2d_path", default="/data/a2d_sentences")
    p.add_argument("--jhmdb_path", default="data/jhmdb_sentences")
    p.add_argument("--max_skip", default=3, type=int)
    p.add_argument("--max_size", default=640, type=int)
    p.add_argument("--remove_difficult", action="store_true")
    p.add_argument("--keep_fps", action="store_true")
    p.add_argument("--cache_mode", action="store_true",
                   help="per-node dataset sharding (NodeShardedSampler)")
    p.add_argument("--vid_aug", action="store_true")
    p.add_argument("--pretrain_enc", action="store_true")
    p.add_argument("--cyclic_lr", action="store_true")
    p.add_argument("--cyclic_lr_boundary", nargs=2, type=float,
                   default=[1e-5, 1e-4])
    p.add_argument("--pretrain_coco", action="store_true")
    p.add_argument("--flat_opt", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="the fused flat AdamW (one update kernel over flat parameter "
                        "and gradient buffers); --no-flat_opt selects torch.optim.AdamW "
                        "over one group per tier (the same update)")
    p.add_argument("--dropout_rng_impl", default="unsafe_rbg",
                   choices=["unsafe_rbg", "rbg", "threefry2x32"],
                   help="accepted for the JAX package's command lines: every value "
                        "draws dropout from torch's generator, seeded from --seed")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--resume", default="")
    p.add_argument("--ckpt_backend", default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="msgpack = checkpoint/ and checkpoint<epoch>/ directories "
                        "of model.pt, optimizer.pt and meta.json; orbax = the "
                        "retained manager (utils/native_ckpt.CheckpointManager)")
    p.add_argument("--ckpt_keep", default=5, type=int,
                   help="checkpoints retained by the orbax backend")
    p.add_argument("--threshold", default=0.5, type=float)
    p.add_argument("--split", default="valid", choices=["valid", "test", "valid_u"])
    p.add_argument("--visualize", action="store_true")
    return p


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tce_rvos_tpu_torch training and inference", add_help=False)
    add_model_args(p)
    add_train_args(p)
    add_data_args(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    return p


def train_config_from_args(args) -> TrainConfig:
    fields = {f.name for f in TrainConfig.__dataclass_fields__.values()}
    kwargs = {}
    for k, v in vars(args).items():
        if k in fields:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
    return TrainConfig(**kwargs)


def data_config_from_args(args) -> DataConfig:
    fields = {f.name for f in DataConfig.__dataclass_fields__.values()}
    return DataConfig(**{k: v for k, v in vars(args).items() if k in fields})
