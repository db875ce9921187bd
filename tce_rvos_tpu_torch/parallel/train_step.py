"""Training step (counterpart of ``tce_rvos_tpu/parallel/train_step.py``):
AdamW with the reference's name-keyed LR tiers, the MultiStep or Cyclic
schedule, global-norm clipping, and one update per batch.

  * LR tiers by parameter name (the reference's ``main.py`` groups): base,
    backbone (``backbone.0``), text encoder (``text_encoder``) and the linear
    projections (``reference_points``, ``sampling_offsets``) at ``lr *
    lr_linear_proj_mult``; ``--pretrain_enc`` freezes everything outside
    ``transformer.encoder.``, ``freeze_text_encoder`` the text encoder.
  * ``torch.optim.AdamW`` with one parameter group per tier, betas
    (0.9, 0.999), eps 1e-8 and decoupled weight decay, which is optax's
    ``adamw`` update; the frozen tier gets no group, so no update and no
    decay. A trainable parameter that received no gradient is given a zero
    one, so that its moments and its decay run as they do in optax.
  * The schedules are evaluated in float32, as optax evaluates them, at the
    step count before the increment.
  * The clip scales every gradient by ``max_norm / norm`` when the global
    norm (over all gradients, the frozen tier's included) reaches
    ``max_norm``, as ``optax.clip_by_global_norm`` does.

``compute_dtype="bfloat16"`` is mixed-precision training with the JAX
package's semantics: the module keeps float32 master weights; inside the
loss its parameters and buffers are cast to bf16 and passed through
``torch.func.functional_call``, so the cast's backward hands float32
gradients to the masters; the video is cast to bf16; the outputs are
upcast to float32 before the criterion. No loss scaling: bf16 has
float32's exponent range.

A resume from a checkpoint without optimizer state fast-forwards only the
schedules' counter (``seed_schedule_step``).

Not ported yet: the fused flat AdamW (a TPU launch-count optimisation with
the same update) and data parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from tce_rvos_tpu_torch.config import TrainConfig
from tce_rvos_tpu_torch.models.criterion import CriterionConfig, criterion
from tce_rvos_tpu_torch.utils.precision import resolve_dtype

Schedule = Callable[[int], float]
TIERS = ("base", "backbone", "text_encoder", "linear_proj")
BETAS, EPS = (0.9, 0.999), 1e-8  # optax.adamw's defaults


def _is_encoder_param(name: str) -> bool:
    """The deformable encoder's parameters: its layers and the FTF memory
    bus and position (``transformer.encoder.memory_bus`` / ``memory_pos``)."""
    return name.startswith("transformer.encoder.")


def param_group(name: str, cfg: TrainConfig) -> str:
    """The LR tier of a parameter, by name, in the JAX package's order."""
    if cfg.pretrain_enc and not _is_encoder_param(name):
        return "frozen"
    if any(k in name for k in cfg.lr_text_encoder_names):
        return "frozen" if cfg.freeze_text_encoder else "text_encoder"
    if any(k in name for k in cfg.lr_backbone_names):
        return "backbone"
    if any(k in name for k in cfg.lr_linear_proj_names):
        return "linear_proj"
    return "base"


def multistep_schedule(base_lr: float, cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    """``base_lr`` times 0.1 for every ``lr_drop`` epoch boundary reached."""
    boundaries = sorted({e * steps_per_epoch for e in cfg.lr_drop})

    def schedule(step: int) -> float:
        v = np.float32(base_lr)
        for b in boundaries:
            if step >= b:
                v = np.float32(np.float32(0.1) * v)
        return float(v)

    return schedule


def cyclic_schedule(lo: float, hi: float, half_period: int) -> Schedule:
    """Triangular CyclicLR: ``lo`` to ``hi`` over ``half_period`` steps and
    back, repeated."""
    half = max(int(half_period), 1)

    def schedule(step: int) -> float:
        phase = np.float32(step % (2 * half)) / np.float32(half)
        tri = np.float32(1.0) - abs(phase - np.float32(1.0))
        return float(np.float32(lo) + np.float32(hi - lo) * tri)

    return schedule


def base_lr_schedule(cfg: TrainConfig, steps_per_epoch: int = 1) -> Schedule:
    """The base tier's LR by step: the ``lr`` metric of the train step."""
    return _tier_schedules(cfg, steps_per_epoch)["base"]


def _tier_schedules(cfg: TrainConfig, steps_per_epoch: int) -> Dict[str, Schedule]:
    if cfg.cyclic_lr:  # one triangle for every tier, as the reference's CyclicLR
        sched = cyclic_schedule(*cfg.cyclic_lr_boundary, steps_per_epoch // 2)
        return {tier: sched for tier in TIERS}
    lrs = {"base": cfg.lr, "backbone": cfg.lr_backbone, "text_encoder": cfg.lr_text_encoder,
           "linear_proj": cfg.lr * cfg.lr_linear_proj_mult}
    return {tier: multistep_schedule(lr, cfg, steps_per_epoch) for tier, lr in lrs.items()}


def make_optimizer(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1
                   ) -> Tuple[torch.optim.AdamW, Dict[str, Schedule]]:
    """AdamW with one group per non-empty, non-frozen tier (each group's
    ``"tier"`` names it), and the tiers' schedules."""
    by_tier: Dict[str, List[nn.Parameter]] = {tier: [] for tier in TIERS}
    for name, p in model.named_parameters():
        tier = param_group(name, cfg)
        if tier != "frozen":
            by_tier[tier].append(p)
    schedules = _tier_schedules(cfg, steps_per_epoch)
    groups = [{"params": ps, "tier": tier, "lr": schedules[tier](0)}
              for tier, ps in by_tier.items() if ps]
    opt = torch.optim.AdamW(groups, betas=BETAS, eps=EPS, weight_decay=cfg.weight_decay)
    return opt, schedules


@dataclasses.dataclass
class TrainState:
    model: nn.Module          # float32 master weights
    optimizer: torch.optim.AdamW
    schedules: Dict[str, Schedule]
    clip_max_norm: float
    step: int = 0


def create_train_state(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1
                       ) -> TrainState:
    """The trainer's entry: seeds torch's generator (dropout) from
    ``cfg.seed`` and builds the optimizer over ``model``'s parameters."""
    torch.manual_seed(cfg.seed)
    opt, schedules = make_optimizer(model, cfg, steps_per_epoch)
    return TrainState(model, opt, schedules, cfg.clip_max_norm)


def batch_to_device(batch: Mapping, device: torch.device) -> Dict:
    """A batch in ``collate_batch``'s format (numpy arrays or tensors, with a
    nested ``targets`` dict) on ``device``; integer arrays become int64."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, Mapping):
            out[k] = batch_to_device(v, device)
            continue
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if not (t.is_floating_point() or t.dtype == torch.bool):
            t = t.long()
        out[k] = t.to(device)
    return out


def _upcast(x, dtype: torch.dtype):
    if torch.is_tensor(x):
        return x.float() if x.dtype == dtype else x
    if isinstance(x, dict):
        return {k: _upcast(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_upcast(v, dtype) for v in x)
    return x


def forward_losses(model: nn.Module, batch: Mapping, crit_cfg: CriterionConfig,
                   compute_dtype: Optional[str] = None):
    """(total loss, dict of weighted losses) for a batch already on the
    model's device; the auxiliary layers' outputs are requested when
    ``model.cfg.aux_loss``."""
    kwargs = dict(video_mask=batch["video_mask"], text_ids=batch["text_ids"],
                  text_attn_mask=batch["text_attn_mask"], sizes=batch["sizes"],
                  aux_outputs=model.cfg.aux_loss)
    cast = None if compute_dtype in (None, "float32") else resolve_dtype(compute_dtype)
    if cast is None:
        outputs = model(batch["video"], **kwargs)
    else:
        tensors = {k: v.to(cast) if v.is_floating_point() else v
                   for k, v in (*model.named_parameters(), *model.named_buffers())}
        outputs = _upcast(functional_call(model, tensors, (batch["video"].to(cast),), kwargs),
                          cast)
    losses = criterion(crit_cfg, outputs, batch["targets"])
    return sum(losses.values()), losses


def make_train_step(crit_cfg: CriterionConfig, compute_dtype: Optional[str] = None
                    ) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``: forward, criterion,
    backward, clip and AdamW update of ``state.model`` in place. ``batch``
    holds the model inputs and a ``targets`` dict (numpy or tensors). The
    metrics are the weighted losses, ``loss``, ``grad_norm`` (before the
    clip) and the base tier's ``lr`` at this step. The caller chooses the
    module's mode: ``train()`` draws dropout, ``eval()`` does not."""

    def step(state: TrainState, batch: Mapping):
        model = state.model
        batch = batch_to_device(batch, next(model.parameters()).device)
        state.optimizer.zero_grad(set_to_none=True)
        total, losses = forward_losses(model, batch, crit_cfg, compute_dtype)
        total.backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["lr"] = state.schedules["base"](state.step)
        metrics["grad_norm"] = apply_gradients(state)
        return state, metrics

    return step


def apply_gradients(state: TrainState) -> torch.Tensor:
    """The update from the gradients in ``p.grad``: the global-norm clip,
    each tier's LR at ``state.step``, one AdamW step, then ``state.step``
    advanced. Returns the norm before the clip."""
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(gnorm < state.clip_max_norm, 1.0,
                                           state.clip_max_norm / gnorm))
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedules[group["tier"]](state.step)
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.step += 1
    return gnorm


def seed_schedule_step(state: TrainState, step: int) -> TrainState:
    """Fast-forward ONLY the schedules' counter (``state.step``) after a
    resume that carried no optimizer state (a reference-format ``.pth``):
    the reference restores its lr_scheduler on resume (main.py:195-211), so
    MultiStep ``lr_drop`` boundaries count from epoch 0, while its Adam
    starts fresh. AdamW's per-parameter ``step`` stays absent (0): a
    bias-correction counter fast-forwarded over zero moments would scale
    the first updates after the resume by about
    (1/(1-b1)) / sqrt(1/(1-b2)) = 3.2x."""
    state.step = int(step)
    return state
