"""Training step (counterpart of ``tce_rvos_tpu/parallel/train_step.py``):
AdamW with the reference's name-keyed LR tiers, the MultiStep or Cyclic
schedule, global-norm clipping, and one update per batch. Two optimizers
run the same update, as in the JAX package: by default (``flat_opt``) the
fused flat AdamW of ``parallel/flat_adamw.py`` (one flat parameter buffer,
one flat gradient buffer, one norm and one update kernel a step), and with
``--no-flat_opt`` ``torch.optim.AdamW`` over one group per tier, the
counterpart of the JAX per-leaf optax chain, described below.

  * LR tiers by parameter name (the reference's ``main.py`` groups): base,
    backbone (``backbone.0``), text encoder (``text_encoder``) and the linear
    projections (``reference_points``, ``sampling_offsets``) at ``lr *
    lr_linear_proj_mult``; ``--pretrain_enc`` freezes everything outside
    ``transformer.encoder.``, ``freeze_text_encoder`` the text encoder.
  * ``--no-flat_opt``: ``torch.optim.AdamW`` with one parameter group per
    tier, betas (0.9, 0.999), eps 1e-8 and decoupled weight decay, which is
    optax's ``adamw`` update; the frozen tier gets no group, so no update and no
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

Every backbone family's parameters are under ``backbone.0``, the backbone
tier. With ``use_checkpoint`` the Swin and Video-Swin backbones recompute
each block in the backward pass, as the transformer does each layer. An X3D
backbone does not train (``create_train_state`` raises): the JAX package
cannot train it, and the port adds no feature the JAX package lacks.

Data parallelism (``parallel/mesh.py``): in a ``torch.distributed`` world
each rank's loss is its part of the global-batch loss
(``models/criterion.py``), the gradients are summed over the ranks in one
all-reduce between ``backward`` and the clip (which then sees the global
gradient, as the JAX step's does): in place on the flat gradient buffer,
or with ``--no-flat_opt`` on the concatenation of the gradients, copied
back. The logged losses are summed the same way. The step does not go
through ``DistributedDataParallel``: ``functional_call``'s bf16 cast would
bypass its forward. gloo has no average, and the sum is what the global batch
needs. Dropout draws from ``seed + rank``, as the JAX trainer's
``seed + process_index``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from tce_rvos_tpu_torch.config import TrainConfig
from tce_rvos_tpu_torch.models.criterion import CriterionConfig, criterion
from tce_rvos_tpu_torch.models.x3d import X3D_CONFIGS
from tce_rvos_tpu_torch.parallel import collectives
from tce_rvos_tpu_torch.parallel.collectives import initialized, process_index
from tce_rvos_tpu_torch.parallel.flat_adamw import STATE_KEY, FlatAdamW, make_layout
from tce_rvos_tpu_torch.utils import profiling
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


def tier_lrs(cfg: TrainConfig) -> Dict[str, float]:
    """Each tier's base LR."""
    return {"base": cfg.lr, "backbone": cfg.lr_backbone, "text_encoder": cfg.lr_text_encoder,
            "linear_proj": cfg.lr * cfg.lr_linear_proj_mult}


def shared_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Tuple[Schedule, Dict[str, float]]:
    """One schedule for every tier and each tier's factor of it: the Cyclic
    triangle (the reference's CyclicLR, one for every group) with every
    factor 1, or MultiStep from 1 with the tier's base LR. The flat AdamW
    takes the product; ``--no-flat_opt`` takes MultiStep from each base LR
    (``_tier_schedules``), as the JAX package's per-leaf chain does."""
    if cfg.cyclic_lr:
        return (cyclic_schedule(*cfg.cyclic_lr_boundary, steps_per_epoch // 2),
                dict.fromkeys(TIERS, 1.0))
    return multistep_schedule(1.0, cfg, steps_per_epoch), tier_lrs(cfg)


def base_lr_schedule(cfg: TrainConfig, steps_per_epoch: int = 1) -> Schedule:
    """The base tier's LR by step under ``--no-flat_opt``."""
    return _tier_schedules(cfg, steps_per_epoch)["base"]


def _tier_schedules(cfg: TrainConfig, steps_per_epoch: int) -> Dict[str, Schedule]:
    common, rels = shared_schedule(cfg, steps_per_epoch)
    if cfg.cyclic_lr:
        return dict.fromkeys(TIERS, common)
    return {tier: multistep_schedule(lr, cfg, steps_per_epoch) for tier, lr in rels.items()}


class LeafAdamW(torch.optim.AdamW):
    """The ``--no-flat_opt`` optimizer: ``torch.optim.AdamW`` with one
    group per non-empty, non-frozen tier (each group's ``"tier"`` names
    it) and the tiers' schedules, behind the train step's optimizer
    interface (``FlatAdamW``'s): ``zero_grad``, ``all_reduce``, ``update``
    (the per-leaf clip, then AdamW), ``seed``, ``lr``, ``lrs``, ``adam_counts``,
    ``unapplied_clip`` and ``update_launches``."""

    update_launches = 0  # it launches no kernel of the port

    def __init__(self, model: nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1):
        by_tier: Dict[str, List[nn.Parameter]] = {tier: [] for tier in TIERS}
        for name, p in model.named_parameters():
            tier = param_group(name, cfg)
            if tier != "frozen":
                by_tier[tier].append(p)
        self.schedules = _tier_schedules(cfg, steps_per_epoch)
        self.clip = cfg.clip_max_norm
        self.sched = 0
        self._model = model
        super().__init__([{"params": ps, "tier": tier, "lr": self.schedules[tier](0)}
                          for tier, ps in by_tier.items() if ps],
                         betas=BETAS, eps=EPS, weight_decay=cfg.weight_decay)

    @torch.no_grad()
    def all_reduce(self) -> None:
        """Sum every parameter's gradient over the ranks in one all-reduce
        of their flattened concatenation, copied back. A parameter without
        a gradient takes part with zeros and keeps None if the sum is zero,
        so that ranks agree on the buffer's layout and one rank reduces to
        itself bitwise."""
        params = [p for p in self._model.parameters() if p.requires_grad]
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                          for p in params])
        collectives.all_reduce_sum_(flat)
        sums = [g.view_as(p) for p, g in zip(params, flat.split([p.numel() for p in params]))]
        have = [i for i, p in enumerate(params) if p.grad is not None]
        torch._foreach_copy_([params[i].grad for i in have], [sums[i] for i in have])
        for i in sorted(set(range(len(params))) - set(have)):
            if sums[i].any():
                params[i].grad = sums[i].clone()

    def update(self) -> torch.Tensor:
        """The global-norm clip of the gradients in ``p.grad`` (in place),
        each tier's LR at ``sched``, one AdamW step; returns the norm before
        the clip."""
        grads = [p.grad for p in self._model.parameters() if p.grad is not None]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.where(gnorm < self.clip, 1.0, self.clip / gnorm))
        for group in self.param_groups:
            group["lr"] = self.schedules[group["tier"]](self.sched)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.step()
        self.sched += 1
        return gnorm

    def seed(self, step: int) -> None:
        """A weights-only resume: the schedules at ``step``; AdamW's
        per-parameter ``step`` stays absent (0)."""
        self.sched = int(step)

    def lr(self) -> float:
        """The base tier's LR at the current schedule step."""
        return self.schedules["base"](self.sched)

    def lrs(self) -> Dict[str, float]:
        """Each tier's LR at the current schedule step."""
        return {g["tier"]: self.schedules[g["tier"]](self.sched) for g in self.param_groups}

    def adam_counts(self) -> set:
        """AdamW's per-parameter step counters (empty before its first step)."""
        return {int(v["step"]) for v in self.state.values()}

    def unapplied_clip(self) -> float:
        """1: ``update`` clips ``p.grad`` in place."""
        return 1.0

    def load_state_dict(self, state_dict: Mapping) -> None:
        """torch's, refusing a state written by the flat AdamW with a
        ``ValueError`` that names the flag."""
        if STATE_KEY in state_dict:
            raise ValueError(
                "the optimizer state was written by the fused flat AdamW (--flat_opt, the "
                "default), and this run trains with torch.optim.AdamW (--no-flat_opt): resume "
                "without --no-flat_opt")
        super().load_state_dict(state_dict)


def make_optimizer(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1
                   ) -> Tuple[LeafAdamW, Dict[str, Schedule]]:
    """The ``--no-flat_opt`` optimizer and the tiers' schedules."""
    opt = LeafAdamW(model, cfg, steps_per_epoch)
    return opt, opt.schedules


Optimizer = Union[FlatAdamW, LeafAdamW]


@dataclasses.dataclass
class TrainState:
    """The model (float32 master weights) and its optimizer; ``step`` is
    the optimizer's schedule step."""

    model: nn.Module
    optimizer: Optimizer

    @property
    def step(self) -> int:
        return self.optimizer.sched

    @step.setter
    def step(self, value: int) -> None:
        self.optimizer.sched = int(value)


def create_train_state(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1
                       ) -> TrainState:
    """The trainer's entry: seeds torch's generator (dropout) from
    ``cfg.seed`` plus the process's rank and builds the optimizer over
    ``model``'s parameters: ``FlatAdamW`` when ``cfg.flat_opt`` (which moves
    the parameters into its flat buffer: build the state after the model is
    on its device), else ``LeafAdamW``. Raises ``ValueError`` for a model
    with an X3D backbone."""
    backbone = getattr(getattr(model, "cfg", None), "backbone", None)
    if backbone in X3D_CONFIGS:
        raise ValueError(
            f"--backbone {backbone}: X3D serves and evaluates in the PyTorch port but does not "
            "train, because the JAX package cannot train it: its X3DBackbone applies a "
            "train-mode flax BatchNorm (tce_rvos_tpu/models/x3d.py:47-58) and its train step "
            "applies the model with deterministic=False and no mutable batch_stats "
            "(tce_rvos_tpu/parallel/train_step.py:203-212), which raises "
            "ModifyScopeVariableError")
    torch.manual_seed(cfg.seed + process_index())
    if cfg.flat_opt:
        return TrainState(model, FlatAdamW(model, make_layout(model, cfg, steps_per_epoch)))
    return TrainState(model, LeafAdamW(model, cfg, steps_per_epoch))


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
    ``model.cfg.aux_loss``. A batch with ``valid_indices`` (A2D's: one
    annotated frame a clip) keeps that frame from the transformer on, as
    the JAX step does."""
    kwargs = dict(video_mask=batch["video_mask"], text_ids=batch["text_ids"],
                  text_attn_mask=batch["text_attn_mask"], sizes=batch["sizes"],
                  valid_indices=batch.get("valid_indices"), aux_outputs=model.cfg.aux_loss)
    cast = None if compute_dtype in (None, "float32") else resolve_dtype(compute_dtype)
    if cast is None:
        outputs = model(batch["video"], **kwargs)
    else:
        with profiling.span("tce.train.cast", 1):
            tensors = {k: v.to(cast) if v.is_floating_point() else v
                       for k, v in (*model.named_parameters(), *model.named_buffers())}
        outputs = _upcast(functional_call(model, tensors, (batch["video"].to(cast),), kwargs),
                          cast)
    with profiling.span("tce.train.criterion", 1):
        losses = criterion(crit_cfg, outputs, batch["targets"])
    return sum(losses.values()), losses


def make_train_step(crit_cfg: CriterionConfig, compute_dtype: Optional[str] = None
                    ) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``: forward, criterion,
    backward, clip and AdamW update of ``state.model`` in place. ``batch``
    holds the model inputs and a ``targets`` dict (numpy or tensors). The
    metrics are the weighted losses, ``loss``, ``grad_norm`` (before the
    clip) and the base tier's ``lr`` at this step. The gradients stay in
    ``p.grad`` after the step: clipped with ``--no-flat_opt``, unclipped in
    the flat buffer (the update applies the clip's factor). The caller
    chooses the module's mode: ``train()`` draws dropout, ``eval()`` does
    not. In a process group the gradients and the metrics' losses are the
    sums over the ranks (the global batch's). Traced, each phase is a
    span under ``tce.train.step``: ``to_device``, ``forward`` (with
    ``cast`` and ``criterion``), ``backward`` and ``update``."""

    def step(state: TrainState, batch: Mapping):
        with profiling.span("tce.train.step", 1):
            model = state.model
            with profiling.span("tce.train.to_device", 1):
                batch = batch_to_device(batch, next(model.parameters()).device)
            # FlatAdamW zeroes its gradient buffer in place (each .grad its view,
            # so that backward adds into it); LeafAdamW sets them to None
            state.optimizer.zero_grad()
            with profiling.span("tce.train.forward", 1):
                total, losses = forward_losses(model, batch, crit_cfg, compute_dtype)
            with profiling.span("tce.train.backward", 1):
                total.backward()
            with profiling.span("tce.train.update", 1):
                all_reduce_gradients(state)
                metrics = sum_over_ranks({**losses, "loss": total})
                metrics["lr"] = state.optimizer.lr()
                metrics["grad_norm"] = apply_gradients(state)
            return state, metrics

    return step


def sum_over_ranks(values: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Detached scalars, each summed over the ranks in one all-reduce."""
    if not initialized():
        return {k: v.detach() for k, v in values.items()}
    flat = collectives.all_reduce_sum_(torch.stack([v.detach().float() for v in values.values()]))
    return dict(zip(values, flat.unbind()))


def all_reduce_gradients(state: TrainState) -> None:
    """Sum every parameter's gradient over the ranks (nothing outside a
    process group) in one all-reduce (``state.optimizer.all_reduce``)."""
    if initialized():
        state.optimizer.all_reduce()


def apply_gradients(state: TrainState) -> torch.Tensor:
    """The update from the gradients (``state.optimizer.update``): the
    global-norm clip, each tier's LR at the schedule step, one AdamW step,
    the step advanced. Returns the norm before the clip."""
    return state.optimizer.update()


def seed_schedule_step(state: TrainState, step: int) -> TrainState:
    """Fast-forward ONLY the schedules' counter (``state.step``) after a
    resume that carried no optimizer state (a reference-format ``.pth``):
    the reference restores its lr_scheduler on resume (main.py:195-211), so
    MultiStep ``lr_drop`` boundaries count from epoch 0, while its Adam
    starts fresh. AdamW's per-parameter ``step`` stays absent (0), and
    ``FlatAdamW``'s ``count`` 0: a bias-correction counter fast-forwarded
    over zero moments would scale the first updates after the resume by
    about (1/(1-b1)) / sqrt(1/(1-b2)) = 3.2x."""
    state.optimizer.seed(step)
    return state
