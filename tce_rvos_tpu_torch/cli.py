"""The model flags of the command line (the port's copy of
``tce_rvos_tpu/cli.py::add_model_args`` and ``model_config_from_args``).

Every flag keeps the reference's name and default, ``--vlblock`` included,
which keeps the reference's inverted store_false meaning (passing it turns
the V-L FPN blocks off). A flag set to a value the port does not support
yet raises and names the flag: nothing is dropped in silence.
``--pre_norm``, ``--masks`` and ``--backbone_pretrained`` change nothing at
inference in either package and are accepted as they are.
"""

from __future__ import annotations

import argparse

from tce_rvos_tpu_torch.config import ModelConfig


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


# flag -> (its value the port cannot run yet, what the port supports)
_UNSUPPORTED = (
    ("--backbone", lambda a: a.backbone != "resnet50", "resnet50 only"),
    ("--dilation", lambda a: a.dilation, "no DC5"),
    ("--binary", lambda a: not a.binary, "--binary is required: one class logit"),
    ("--vlblock", lambda a: not a.vlblock, "the V-L FPN blocks stay on"),
    ("--no_rel_coord", lambda a: not a.rel_coord, "relative coordinates stay on"),
    ("--f_token", lambda a: a.f_token < 0, "f_token >= 0 (no LastLayerAsToken)"),
    ("--two_stage", lambda a: a.two_stage, "single stage"),
    ("--vis_loss", lambda a: a.vis_loss, "no visibility head"),
    ("--contrastive", lambda a: a.contrastive, "no contrastive head"),
    ("--position_embedding", lambda a: a.position_embedding != "sine", "sine only"),
    ("--msda_impl", lambda a: a.msda_impl != "auto",
     "auto only: the device picks the MSDA implementation"),
)


def model_config_from_args(args) -> ModelConfig:
    """The port's ``ModelConfig`` from parsed ``add_model_args`` flags;
    raises ``ValueError`` naming the first flag whose value it cannot run."""
    for flag, unsupported, supported in _UNSUPPORTED:
        if unsupported(args):
            raise ValueError(f"{flag}: not supported by the PyTorch port yet ({supported})")
    fields = {f.name for f in ModelConfig.__dataclass_fields__.values()}
    return ModelConfig(**{k: v for k, v in vars(args).items() if k in fields})
