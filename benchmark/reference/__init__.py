"""The benchmark's plain reference of TCE-RVOS: a frozen copy of the
port's model code in plain PyTorch (MSDA as a plain gather, no kernel, no
sharding), its criterion and matcher, and AdamW with the trainer's tiers
and clip. It imports nothing of the program. ``model_config`` builds its
``ModelConfig`` from a configuration file's keys; ``build`` the model;
``families`` maps each backbone name to its family, the module
``backbone_<family>.py`` that builds and counts it (``backbones.py``)."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from .backbones import families, family
from .config import ModelConfig, TrainConfig
from .referformer import ReferFormer, init_weights


def model_config(cfg: Mapping) -> ModelConfig:
    """The reference's ModelConfig from a configuration file's keys."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def train_config(cfg: Mapping) -> TrainConfig:
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in cfg.get("train", {}).items() if k in names})


def build(cfg: Mapping, device) -> ReferFormer:
    """The reference model of ``cfg`` on ``device`` (float32, eval mode),
    with its parameters as the module makes them; load a state dict next."""
    with torch.device(device):
        model = ReferFormer(model_config(cfg))
    return model.eval()


__all__ = ["ReferFormer", "init_weights", "model_config", "train_config", "build", "families",
           "family"]
