"""The fused flat AdamW (counterpart of
``tce_rvos_tpu/parallel/flat_adamw.py``), the trainer's default
(``--flat_opt``): the reference's optimizer semantics (name-keyed LR tiers,
AdamW with decoupled weight decay, the MultiStep or Cyclic schedule,
global-norm clipping) run as one norm and one update kernel over flat f32
buffers, in place of one AdamW group per tier over ~700 tensors.

* ``FlatLayout`` (``make_layout``): the parameters sorted by tier
  ``frozen | base | backbone | text_encoder | linear_proj`` (stable within a
  tier), their offsets, the frozen prefix's length, the live tiers as at
  most four contiguous ``(lo, hi, rel)`` slices in live coordinates, and the
  shared schedule ``common(step)`` with each tier's ``rel``
  (``train_step.shared_schedule``). The LR of an element is
  ``common(sched) * rel`` in f32, the JAX flat formula (not the per-tier
  schedules of ``--no-flat_opt``, which round otherwise). Unlike the JAX
  layout, every parameter starts on a 256-byte boundary (``ALIGN``
  elements): cuBLAS and cuDNN choose their kernels by the alignment of
  their operands, so an f32 forward through unaligned views of the buffer
  rounds otherwise than the same weights in their own tensors. The padding
  (zeros with zero gradients) stays zero under the update.
* ``flatten_parameters``: every parameter becomes a view of one contiguous
  f32 buffer on the model's device, and its ``.grad`` a view of one flat
  gradient buffer of the same length (the frozen prefix included: the
  norm counts frozen gradients, as the JAX one does). Autograd then adds
  each backward's gradients into the buffer in place. Anything that
  replaces a parameter's storage afterwards (``.to`` another device or
  dtype, ``load_state_dict(assign=True)``, ``p.data = ...``) breaks the
  views, and the step raises; ``load_state_dict`` (a copy) and
  ``replicate``'s in-place broadcast keep them. A ``.grad`` set to None or
  replaced before the step is pointed back at its view by its
  ``zero_grad``; one replaced between ``zero_grad`` and ``update`` (during
  the backward) would miss the buffer, and ``update`` raises.
* ``FlatAdamW``: the state ``count``, ``sched`` (Python ints), ``mu`` and
  ``nu`` (f32, live width: frozen moments are never stored) and ``gnorm``,
  as ``FlatAdamWState``. It has the train step's optimizer interface
  (``zero_grad``, ``all_reduce``, ``update``, ``seed``, ``lr``, ``lrs``,
  ``adam_counts``, ``unapplied_clip``, ``update_launches``), as
  ``train_step.LeafAdamW`` does
  for ``--no-flat_opt``. ``update()`` takes ``gnorm = ||g||_2`` over the
  whole gradient buffer (one reduction) and runs one update over the live
  range (``flat_adamw_update``): the kernel ``csrc/flat_adamw.cu`` on the
  card, ``flat_adamw_update_plain`` on the CPU. The update is ``_moments`` +
  ``apply_params`` of the JAX package: the clip scale ``clip / gnorm``
  when ``gnorm >= clip``, bias corrections at ``count + 1`` in f32, the
  LR at the pre-increment ``sched``; frozen elements are untouched (no
  decay, no update). The gradient buffer itself stays unclipped, as the
  JAX step's gradients do. No ``.item()``: the step adds no host sync.
* ``state_dict`` / ``load_state_dict`` carry the layout (names, sizes,
  tiers); a state of another layout, or one written by
  ``torch.optim.AdamW`` (``--no-flat_opt``), is refused with a
  ``ValueError`` naming the flag, as the JAX package's checkpoint loader
  refuses the other optimizer's state (``load_optimizer_state``);
  ``train_step.LeafAdamW`` refuses a flat state likewise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from tce_rvos_tpu_torch.config import TrainConfig
from tce_rvos_tpu_torch.ops.flat_adamw_cuda import UpdateScalars, flat_adamw_cuda
from tce_rvos_tpu_torch.parallel import collectives

TIER_ORDER = ("frozen", "base", "backbone", "text_encoder", "linear_proj")
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults
STATE_KEY = "flat_adamw"        # the layout's entry in a state_dict
ALIGN = 64                      # elements: every parameter on a 256-byte boundary


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """The tier-sorted flat layout and the shared schedule (``_Layout`` of
    the JAX package), by parameter name."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]      # into the full (frozen-inclusive) buffer
    tiers: Tuple[str, ...]
    frozen_len: int
    live_total: int
    tier_slices: Tuple[Tuple[int, int, float], ...]  # (lo, hi, rel), live coordinates
    live_tiers: Tuple[str, ...]   # the tier of each slice
    common: Callable[[int], float]
    base_rel: float               # the base tier's rel: the logged LR's
    wd: float
    clip: float

    @property
    def total(self) -> int:
        return self.frozen_len + self.live_total

    def describe(self) -> Dict[str, List]:
        """What a state_dict records of the layout, to refuse another one."""
        return {"names": list(self.names), "sizes": list(self.sizes), "tiers": list(self.tiers)}


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def make_layout(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1) -> FlatLayout:
    """The flat layout of ``model``'s parameters under ``cfg``'s tiers: each
    parameter at an ``ALIGN``-element boundary, each tier (and the frozen
    prefix) ending at one."""
    from tce_rvos_tpu_torch.parallel.train_step import param_group, shared_schedule

    named = sorted(model.named_parameters(),
                   key=lambda item: TIER_ORDER.index(param_group(item[0], cfg)))
    names = tuple(n for n, _ in named)
    shapes = tuple(tuple(p.shape) for _, p in named)
    sizes = tuple(p.numel() for _, p in named)
    tiers = tuple(param_group(n, cfg) for n in names)
    offsets, ends, end = [], {}, 0
    for tier, sz in zip(tiers, sizes):
        offsets.append(end)
        end = _aligned(end + sz)
        ends[tier] = end
    frozen_len = ends.get("frozen", 0)
    common, rels = shared_schedule(cfg, steps_per_epoch)
    live_tiers = tuple(t for t in TIER_ORDER[1:]
                       if any(sz for u, sz in zip(tiers, sizes) if u == t))
    tier_slices, lo = [], 0
    for tier in live_tiers:
        tier_slices.append((lo, ends[tier] - frozen_len, rels[tier]))
        lo = ends[tier] - frozen_len
    return FlatLayout(names=names, shapes=shapes, sizes=sizes, offsets=tuple(offsets),
                      tiers=tiers, frozen_len=frozen_len, live_total=end - frozen_len,
                      tier_slices=tuple(tier_slices), live_tiers=live_tiers, common=common,
                      base_rel=rels["base"],
                      wd=cfg.weight_decay, clip=cfg.clip_max_norm)


def update_scalars(layout: FlatLayout, count: int, sched: int) -> UpdateScalars:
    """The f32 scalars of the update at Adam step ``count`` and schedule
    step ``sched`` (both before the increment), each taken in f32 as the
    JAX package takes it."""
    f32 = np.float32
    c = f32(count + 1)
    lr_t = f32(layout.common(sched))
    lrs = [f32(lr_t * f32(rel)) for _, _, rel in layout.tier_slices]
    return UpdateScalars(
        his=tuple(hi for _, hi, _ in layout.tier_slices),
        lrs=tuple(float(lr) for lr in lrs),
        decays=tuple(float(f32(1) - lr * f32(layout.wd)) for lr in lrs),
        clip=float(f32(layout.clip)), b1=float(f32(B1)), omb1=float(f32(1.0 - B1)),
        b2=float(f32(B2)), omb2=float(f32(1.0 - B2)),
        bc1=float(f32(1) - f32(B1) ** c), bc2=float(f32(1) - f32(B2) ** c),
        eps=float(f32(EPS)))


def _scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``like``'s device. Dividing by it
    rounds once; torch divides a CUDA tensor by a Python number as a
    multiplication by its reciprocal, which rounds twice."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def clip_scale(gnorm: torch.Tensor, clip: float) -> torch.Tensor:
    """The factor of the global-norm clip: 1 below ``clip``, else
    ``clip / gnorm`` (f32, on gnorm's device)."""
    return torch.where(gnorm < clip, 1.0, _scalar(gnorm, clip) / gnorm)


@torch.no_grad()
def flat_adamw_update_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                            nu: torch.Tensor, gnorm: torch.Tensor, s: UpdateScalars) -> None:
    """The kernel's update in plain torch ops, each rounded once to f32 as
    the kernel rounds it, in place on the live ranges ``p``, ``mu`` and
    ``nu`` (see the module docstring). The square root is taken in f64 and
    rounded to f32, which is the correctly rounded f32 root: torch's
    vectorised CPU ``sqrt`` of f32 is not."""
    gs = g * clip_scale(gnorm, s.clip)
    mu.mul_(s.b1).add_(gs * s.omb1)
    nu.mul_(s.b2).add_((gs * gs).mul_(s.omb2))
    root = (nu / _scalar(nu, s.bc2)).double().sqrt_().float()
    adam = (mu / _scalar(mu, s.bc1)).div_(root.add_(s.eps))
    lo = 0
    for hi, lr, decay in zip(s.his, s.lrs, s.decays):
        p[lo:hi].mul_(decay).sub_(adam[lo:hi].mul_(lr))
        lo = hi


def global_norm(g: torch.Tensor) -> torch.Tensor:
    """``||g||_2`` of the flat gradient buffer: one ``vector_norm`` on the
    card (a tree reduction); on the CPU ``sqrt(sum(g * g))``, the JAX
    formula, whose sum torch takes in a cascade: torch's CPU ``vector_norm``
    adds the squares in a running f32 sum, 0.3% off at 42M elements."""
    if g.is_cuda:
        return torch.linalg.vector_norm(g)
    return torch.sqrt(torch.sum(g * g))


def flat_adamw_update(p, g, mu, nu, gnorm, s: UpdateScalars) -> None:
    """The update on CUDA tensors by the kernel (``ops/flat_adamw_cuda.py``,
    which raises if it cannot build or launch), on CPU tensors by
    ``flat_adamw_update_plain``."""
    if p.numel() == 0:
        return
    if p.is_cuda:
        flat_adamw_cuda(p, g, mu, nu, gnorm, s)
    else:
        flat_adamw_update_plain(p, g, mu, nu, gnorm, s)


@torch.no_grad()
def flatten_parameters(model: nn.Module, layout: FlatLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move ``model``'s parameters into one f32 buffer in ``layout``'s
    order, each ``p.data`` a view of it (the old storage freed), and point
    each ``p.grad`` at its view of a zeroed gradient buffer of the same
    length. Returns (parameter buffer, gradient buffer)."""
    params = [model.get_parameter(n) for n in layout.names]
    device = params[0].device
    for name, p in zip(layout.names, params):
        if p.dtype != torch.float32 or p.device != device:
            raise ValueError(f"the flat AdamW keeps float32 master weights on one device; "
                             f"{name} is {p.dtype} on {p.device}")
    flat = torch.zeros(layout.total, dtype=torch.float32, device=device)  # padding stays 0
    grads = torch.zeros_like(flat)
    for p, o, sz, shape in zip(params, layout.offsets, layout.sizes, layout.shapes):
        view = flat[o:o + sz].view(shape)
        view.copy_(p)
        p.data = view
        p.grad = grads[o:o + sz].view(shape)
    return flat, grads


class FlatAdamW:
    """The fused flat AdamW over ``model``'s parameters (see the module
    docstring); ``params`` and ``grads`` are the flat buffers."""

    update_launches = 1  # update kernel launches a step on the card

    def __init__(self, model: nn.Module, layout: FlatLayout):
        self.layout = layout
        self.params, self.grads = flatten_parameters(model, layout)
        self._params = [model.get_parameter(n) for n in layout.names]
        self._grad_views = [p.grad for p in self._params]
        self._ptrs = [p.data_ptr() for p in self._params]
        self.count = 0   # Adam's step (bias correction)
        self.sched = 0   # the schedule's step, seeded apart on a weights-only resume
        self.mu = torch.zeros(layout.live_total, dtype=torch.float32, device=self.params.device)
        self.nu = torch.zeros_like(self.mu)
        self.gnorm = torch.zeros((), dtype=torch.float32, device=self.params.device)

    def zero_grad(self) -> None:
        """Zero the gradient buffer in place and point every ``.grad`` that
        was set to None or replaced back at its view; raise if a parameter
        no longer lies in the parameter buffer."""
        for name, p, view, ptr in zip(self.layout.names, self._params, self._grad_views,
                                      self._ptrs):
            if p.data_ptr() != ptr:
                raise RuntimeError(
                    f"{name} no longer lies in the flat AdamW's parameter buffer (its storage "
                    "was replaced after create_train_state, e.g. by .to() or "
                    "load_state_dict(assign=True)); build the train state after the model's "
                    "last move, or train with --no-flat_opt")
            if p.grad is not view:
                p.grad = view
        self.grads.zero_()

    def all_reduce(self) -> None:
        """Sum the gradient buffer over the ranks: one all-reduce, in place."""
        collectives.all_reduce_sum_(self.grads)

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        """One update from the gradient buffer; returns the global norm
        before the clip (a 0-d tensor on the buffers' device). Raises if a
        ``.grad`` was replaced since ``zero_grad``: its gradient is not in
        the buffer."""
        for name, p, view in zip(self.layout.names, self._params, self._grad_views):
            if p.grad is not view:
                raise RuntimeError(
                    f"the gradient of {name} was replaced after the step's zero_grad, so it is "
                    "not in the flat AdamW's gradient buffer; add into p.grad in place, or "
                    "train with --no-flat_opt")
        lay = self.layout
        self.gnorm = global_norm(self.grads)
        flat_adamw_update(self.params[lay.frozen_len:], self.grads[lay.frozen_len:], self.mu,
                          self.nu, self.gnorm, update_scalars(lay, self.count, self.sched))
        self.count += 1
        self.sched += 1
        return self.gnorm

    def seed(self, step: int) -> None:
        """A weights-only resume: the schedule at ``step``, Adam's count 0."""
        self.sched = int(step)

    def lr(self) -> float:
        """The base tier's LR at the current schedule step, in f32."""
        return float(np.float32(np.float32(self.layout.common(self.sched))
                                * np.float32(self.layout.base_rel)))

    def lrs(self) -> Dict[str, float]:
        """Each live tier's LR at the current schedule step, in f32."""
        return dict(zip(self.layout.live_tiers,
                        update_scalars(self.layout, self.count, self.sched).lrs))

    def adam_counts(self) -> set:
        """Adam's step counter (bias correction), as a set."""
        return {self.count}

    def unapplied_clip(self) -> torch.Tensor:
        """The factor between ``p.grad`` after ``update`` and the clipped
        gradient that it applied: the clip's, since the buffer stays
        unclipped."""
        return clip_scale(self.gnorm, self.layout.clip)

    def state_dict(self) -> Dict:
        return {STATE_KEY: self.layout.describe(), "count": self.count, "sched": self.sched,
                "mu": self.mu, "nu": self.nu, "gnorm": self.gnorm}

    def load_state_dict(self, state: Mapping) -> None:
        if STATE_KEY not in state:
            raise ValueError(
                "the optimizer state was written by torch.optim.AdamW (--no-flat_opt), and this "
                "run trains with the fused flat AdamW (--flat_opt, the default): resume with "
                "--no-flat_opt")
        if state[STATE_KEY] != self.layout.describe():
            raise ValueError(
                "the optimizer state was written by the fused flat AdamW (--flat_opt) over "
                "another layout (other parameters, or other tiers: --pretrain_enc, "
                "freeze_text_encoder) than this run's; resume with the flags it was trained "
                "with (--flat_opt / --no-flat_opt and the tier flags)")
        self.count, self.sched = int(state["count"]), int(state["sched"])
        self.mu.copy_(state["mu"])
        self.nu.copy_(state["nu"])
        self.gnorm = state["gnorm"].to(self.gnorm.device, torch.float32).clone()
