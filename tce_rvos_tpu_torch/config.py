"""Model configuration of the port: its own copy of the architecture
fields of ``tce_rvos_tpu/config.py::ModelConfig`` that the serving path
reads, with the same names and defaults, and ``flagship_config``.

``msda_impl`` is gone: the device decides (the CUDA kernel on the card, the
plain version on the CPU). ``compute_dtype`` stays: "bfloat16" casts the
weights and the video once at the engine's boundary, as in the JAX package.

What the port supports of the rest is fixed, not configurable: a ResNet-50
backbone without DC5, the V-L blocks of the FPN, relative coordinates in
the dynamic mask head, and one class logit (``--binary``). Training fields
and the options not ported yet (the other backbones, DC5, ``vis_loss``,
``contrastive``, ``msda_3d``, ``f_token < 0``, the non-binary class counts)
come with their code and a parity test against the JAX package.
"""

from __future__ import annotations

import dataclasses

NUM_CLASSES = 1  # --binary: one "is referred" logit per query


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (the JAX package's names and defaults)."""

    num_feature_levels: int = 4

    # Transformer
    enc_layers: int = 4
    dec_layers: int = 4
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    nheads: int = 8
    num_frames: int = 5
    num_queries: int = 5
    dec_n_points: int = 4
    enc_n_points: int = 4
    with_box_refine: bool = False

    # Text encoder (defaults = roberta-base)
    text_encoder_layers: int = 12
    text_encoder_hidden: int = 768
    text_encoder_heads: int = 12
    text_encoder_intermediate: int = 3072

    # Segmentation
    mask_dim: int = 256
    controller_layers: int = 3
    dynamic_mask_channels: int = 8

    # TCE variants
    qtrans: bool = False                  # IQT
    f_token: int = 0                      # FTF: > 0 learnable frame tokens

    compute_dtype: str = "float32"        # "bfloat16" for the fast path


def flagship_config(**overrides) -> ModelConfig:
    """The flagship configuration: --with_box_refine --binary --f_token 8
    --qtrans (``--binary`` is the port's only class head)."""
    base = dict(with_box_refine=True, f_token=8, qtrans=True)
    base.update(overrides)
    return ModelConfig(**base)
