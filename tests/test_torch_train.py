"""The PyTorch port's training slice against the JAX package, on the CPU.

* Box ops, ``dice_loss``, ``sigmoid_focal_loss``, ``match`` and
  ``criterion`` against the JAX functions on seeded outputs and targets
  (b = 2 multi-frame clips, an invalid frame, auxiliary layers, one and
  three classes, with and without the visibility head's output), rtol =
  atol = 1e-5: the same f32 arithmetic in another order.
* ``param_group`` gives every parameter of the tiny model the JAX tier of
  its flax path (names mapped by ``utils/convert.py``), and the per-tier
  schedules equal the JAX ones exactly (float32) at steps 0-20.
* The slice as a whole: two steps of ``make_train_step`` on the tiny
  flagship-shaped model (FTF, IQT, box refinement, binary, f32, dropout
  off) against ``jax.value_and_grad`` of the JAX model's loss and the
  optax chain of ``make_optimizer``, from the same weights and batch. The
  JAX package's ``make_train_step`` always draws dropout, so its loss is
  built here from ``model.apply(..., deterministic=True)`` and
  ``criterion``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from tce_rvos_tpu.config import ModelConfig as JaxModelConfig
from tce_rvos_tpu.config import TrainConfig as JaxTrainConfig
from tce_rvos_tpu.models import matcher as jax_matcher
from tce_rvos_tpu.models import segmentation as jax_seg
from tce_rvos_tpu.models.criterion import CriterionConfig as JaxCriterionConfig
from tce_rvos_tpu.models.criterion import criterion as jax_criterion
from tce_rvos_tpu.models.criterion import criterion_from_configs as jax_criterion_from_configs
from tce_rvos_tpu.parallel import train_step as jax_ts
from tce_rvos_tpu.utils import boxes as jax_boxes
from tce_rvos_tpu_torch.config import ModelConfig, TrainConfig
from tce_rvos_tpu_torch.models import segmentation
from tce_rvos_tpu_torch.models.criterion import (
    CriterionConfig,
    criterion,
    criterion_from_configs,
)
from tce_rvos_tpu_torch.models.matcher import MatcherConfig, match
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.parallel import train_step
from tce_rvos_tpu_torch.utils import boxes
from tce_rvos_tpu_torch.utils.convert import torch_key
from torch_parity_helpers import (FLAGSHIP_TINY, assert_close, check_two_train_steps, model_inputs,
                                  random_boxes, tiny_model, train_targets)

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


_boxes = random_boxes


# ---- box ops and losses --------------------------------------------------------

def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    b1, b2 = _boxes(rng, 3, 5), _boxes(rng, 3, 4)
    x1, x2 = (jax_boxes.box_cxcywh_to_xyxy(jnp.asarray(b)) for b in (b1, b2))
    p1, p2 = (boxes.box_cxcywh_to_xyxy(_t(b)) for b in (b1, b2))
    assert_close(p1, x1, **LOSS_TOL)
    assert_close(boxes.box_area(p1), jax_boxes.box_area(x1), **LOSS_TOL)
    for got, want in zip(boxes.box_iou(p1, p2), jax_boxes.box_iou(x1, x2)):
        assert_close(got, want, **LOSS_TOL)
    assert_close(boxes.generalized_box_iou(p1, p2), jax_boxes.generalized_box_iou(x1, x2),
                 **LOSS_TOL)
    assert_close(boxes.elementwise_giou(p1[:, :4], p2), jax_boxes.elementwise_giou(x1[:, :4], x2),
                 **LOSS_TOL)


def test_dice_and_focal_losses_match_jax():
    rng = np.random.RandomState(1)
    logits = (rng.randn(4, 300) * 3).astype(np.float32)
    targets = (rng.rand(4, 300) > 0.6).astype(np.float32)
    for fn in ("dice_loss", "sigmoid_focal_loss"):
        got = getattr(segmentation, fn)(_t(logits), _t(targets), 3.0)
        want = getattr(jax_seg, fn)(jnp.asarray(logits), jnp.asarray(targets), 3.0)
        assert_close(got, want, name=fn, **LOSS_TOL)


def _outputs_and_targets(num_classes, seed, vis, b=2, t=3, q=5, hw=(8, 12)):
    """Seeded outputs of a model with two auxiliary layers, and targets with
    one invalid frame (``valid = 0``)."""
    rng = np.random.RandomState(seed)
    h, w = hw

    def layer():
        out = {"pred_logits": rng.randn(b, t, q, num_classes).astype(np.float32),
               "pred_boxes": _boxes(rng, b, t, q),
               "pred_masks": (rng.randn(b, t, q, h, w) * 2).astype(np.float32)}
        if vis:
            out["pred_visible"] = rng.randn(b, t, q, 1).astype(np.float32)
        return out

    outputs = layer()
    outputs["aux_outputs"] = [layer(), layer()]
    valid = np.ones((b, t), np.int32)
    valid[0, 1] = 0
    targets = {"labels": rng.randint(0, num_classes, (b, t)).astype(np.int32),
               "boxes": _boxes(rng, b, t),
               "masks": (rng.rand(b, t, 4 * h, 4 * w) > 0.5).astype(np.float32),
               "valid": valid}
    return outputs, targets


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


# jitted, so that each case compiles once rather than every op per shape
_jax_match = jax.jit(jax_matcher.match, static_argnums=0)
_jax_criterion = jax.jit(jax_criterion, static_argnums=0)
CASES = [(1, False), (3, False), (1, True)]
CASE_IDS = ["binary", "three_classes", "binary_vis"]


@pytest.mark.parametrize("num_classes,vis", CASES, ids=CASE_IDS)
def test_match_matches_jax(num_classes, vis):
    mcfg = dict(num_classes=num_classes, use_vis=vis)
    for seed in range(4):
        outputs, targets = _outputs_and_targets(num_classes, seed, vis)
        for layer in [outputs] + outputs["aux_outputs"]:
            args = [layer["pred_logits"], layer["pred_boxes"], layer["pred_masks"],
                    targets["labels"], targets["boxes"], targets["masks"], targets["valid"],
                    layer.get("pred_visible")]
            want = _jax_match(jax_matcher.MatcherConfig(**mcfg),
                              *(None if a is None else jnp.asarray(a) for a in args))
            got = match(MatcherConfig(**mcfg), *(None if a is None else _t(a) for a in args))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_classes,vis", CASES, ids=CASE_IDS)
def test_criterion_matches_jax(num_classes, vis):
    outputs, targets = _outputs_and_targets(num_classes, seed=7, vis=vis)
    kw = dict(num_classes=num_classes, use_vis=vis)
    want = _jax_criterion(JaxCriterionConfig(**kw, matcher=jax_matcher.MatcherConfig(**kw)),
                          _to(outputs, jnp.asarray), _to(targets, jnp.asarray))
    got = criterion(CriterionConfig(**kw, matcher=MatcherConfig(**kw)),
                    _to(outputs, _t), _to(targets, _t))
    assert sorted(got) == sorted(want)
    assert "loss_dice_1" in got and ("loss_vis" in got) == vis
    for k in want:
        assert_close(got[k], want[k], name=k, **LOSS_TOL)


def test_criterion_from_configs_matches_jax():
    tcfg = TrainConfig(cls_loss_coef=3.0, set_cost_giou=1.5)
    jcfg = jax_criterion_from_configs(JaxModelConfig(binary=True),
                                      JaxTrainConfig(cls_loss_coef=3.0, set_cost_giou=1.5))
    assert criterion_from_configs(ModelConfig(), tcfg) == CriterionConfig(
        **{f.name: getattr(jcfg, f.name) for f in jcfg.__dataclass_fields__.values()
           if f.name != "matcher"},
        matcher=MatcherConfig(**vars(jcfg.matcher)))


# ---- optimizer tiers and schedules ---------------------------------------------

@pytest.fixture(scope="module")
def tiny_flagship():
    """The JAX tiny flagship model and seeded variables (traced, never
    compiled)."""
    return tiny_model("flagship")


TRAIN_CFGS = {"default": {}, "freeze_text_encoder": dict(freeze_text_encoder=True),
              "pretrain_enc": dict(pretrain_enc=True)}


@pytest.mark.parametrize("which", sorted(TRAIN_CFGS))
def test_param_group_matches_jax_tiers(tiny_flagship, which):
    _, _, variables, _, _ = tiny_flagship
    jcfg, tcfg = JaxTrainConfig(**TRAIN_CFGS[which]), TrainConfig(**TRAIN_CFGS[which])
    port = ReferFormer(ModelConfig(**FLAGSHIP_TINY))
    names = {n for n, _ in port.named_parameters()}
    seen = {}
    for path in traverse_util.flatten_dict(variables["params"], sep="/"):
        name = torch_key(f"params/{path}")
        assert name in names, path
        tier = jax_ts.param_group(path, jcfg)
        assert seen.setdefault(name, tier) == tier, path  # q/k/v share one packed tensor
        assert train_step.param_group(name, tcfg) == tier, (path, name)
    assert set(seen) == names
    # the optimizer has one group per live tier and none for the frozen one
    opt, _ = train_step.make_optimizer(port, tcfg)
    grouped = {id(p): g["tier"] for g in opt.param_groups for p in g["params"]}
    for name, p in port.named_parameters():
        assert grouped.get(id(p), "frozen") == seen[name], name


def test_schedules_match_jax_exactly():
    """MultiStep across two ``lr_drop`` boundaries (steps 10 and 15) and the
    CyclicLR triangle, per tier, at steps 0-20, as float32."""
    for kw, spe in ((dict(lr_drop=(2, 3), lr_linear_proj_mult=0.5), 5),
                    (dict(cyclic_lr=True), 8)):
        jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
        lrs = {"base": jcfg.lr, "backbone": jcfg.lr_backbone,
               "text_encoder": jcfg.lr_text_encoder,
               "linear_proj": jcfg.lr * jcfg.lr_linear_proj_mult}
        _, port = train_step.make_optimizer(torch.nn.Linear(2, 2), tcfg, spe)
        for tier, lr in lrs.items():
            want = (jax_ts.cyclic_schedule(*jcfg.cyclic_lr_boundary, spe // 2) if jcfg.cyclic_lr
                    else jax_ts.multistep_schedule(lr, jcfg, spe))
            for step in range(21):
                assert np.float32(port[tier](step)) == np.float32(want(step)), (kw, tier, step)
        base = train_step.base_lr_schedule(tcfg, spe)
        jbase = jax_ts.base_lr_schedule(jcfg, spe)
        assert [np.float32(base(s)) for s in range(21)] == [np.float32(jbase(s)) for s in range(21)]


# ---- the slice: two train steps --------------------------------------------------

def test_two_train_steps_match_jax():
    """Two steps of the tiny flagship against JAX (f32, dropout off), held
    as ``torch_parity_helpers.check_two_train_steps`` says."""
    check_two_train_steps("flagship")


# ---- recomputation and the epoch loop ---------------------------------------------

def _tiny_port(**overrides):
    from tce_rvos_tpu_torch.models.build import build_model

    return build_model(ModelConfig(**FLAGSHIP_TINY, **overrides), device="cpu", seed=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recomputation_gives_the_same_gradients(dtype):
    """use_checkpoint recomputes each encoder and decoder layer in the
    backward pass; on the CPU nothing is reordered, so the gradients are
    bitwise those without it, also under the bf16 step's functional_call
    casts (the recomputation must use the bf16 copies the forward used)."""
    model = _tiny_port().eval()
    cfg, tcfg = model.cfg, TrainConfig()
    batch = train_step.batch_to_device(dict(model_inputs(), targets=train_targets()),
                                       torch.device("cpu"))
    grads, totals = [], []
    for ckpt in (False, True):
        model.transformer.use_checkpoint = ckpt
        model.zero_grad(set_to_none=True)
        total, _ = train_step.forward_losses(model, batch, criterion_from_configs(cfg, tcfg), dtype)
        total.backward()
        totals.append(float(total))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert totals[0] == totals[1]
    for name, g in grads[0].items():
        assert g.dtype == torch.float32, name  # master weights get f32 gradients
        assert torch.equal(g, grads[1][name]), name


def test_train_one_epoch_updates_and_stops_on_non_finite_loss(capsys):
    """Two bf16 steps with dropout through the epoch loop: finite losses,
    every parameter moved, f32 master weights; then a step whose loss is not
    finite stops training."""
    from tce_rvos_tpu_torch.engine import train_one_epoch

    model = _tiny_port(compute_dtype="bfloat16")
    tcfg = TrainConfig()
    state = train_step.create_train_state(model, tcfg, steps_per_epoch=2)
    step = train_step.make_train_step(criterion_from_configs(model.cfg, tcfg), "bfloat16")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    batches = [dict(model_inputs(seed=i), targets=train_targets(seed=i)) for i in range(2)]
    state, stats = train_one_epoch(state, step, batches, epoch=0)
    assert model.training and state.step == 2
    assert np.isfinite(stats["loss"]) and stats["grad_norm"] > 0
    assert {"loss_ce", "loss_mask_0", "lr"} <= set(stats)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and not torch.equal(p.detach(), start[name]), name

    def bad_step(st, batch):
        return st, {"loss": torch.tensor(float("nan")), "loss_ce": torch.tensor(1.0)}

    with pytest.raises(SystemExit):
        train_one_epoch(state, bad_step, batches[:1], epoch=1)
    assert "stopping training" in capsys.readouterr().out
