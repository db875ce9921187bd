"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Weights are made with numpy from a seed and given to both frameworks. Every
leaf gets seeded noise: at the JAX package's own init the MSDA offset and
attention kernels are zero, which makes the attention weights uniform and
the top-k sample export a tie, and the parity tests weak.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from tce_rvos_tpu.config import ModelConfig as JaxModelConfig
from tce_rvos_tpu.config import TrainConfig as JaxTrainConfig
from tce_rvos_tpu.models.build import build_model as jax_build_model
from tce_rvos_tpu.models.criterion import criterion as jax_criterion
from tce_rvos_tpu.models.criterion import criterion_from_configs as jax_criterion_from_configs
from tce_rvos_tpu.parallel import train_step as jax_ts
from tce_rvos_tpu_torch.config import ModelConfig, TrainConfig
from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.parallel import train_step
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax


# tests/test_checkpoint.py's TINY (binary, the port's only class head) plus
# the flagship's switches, or without them: the plain ReferFormer
TINY = dict(enc_layers=2, dec_layers=2, dim_feedforward=64,
            text_encoder_layers=2, text_encoder_hidden=64,
            text_encoder_heads=4, text_encoder_intermediate=128)
VARIANTS = {"flagship": dict(TINY, f_token=2, qtrans=True, with_box_refine=True),
            "plain": TINY}
FLAGSHIP_TINY = VARIANTS["flagship"]
# the flagship with temporal MSDA in the encoder and decoder (--msda_3d)
VARIANTS["flagship_3d"] = FLAGSHIP_3D_TINY = dict(FLAGSHIP_TINY, msda_3d=True)
B, T, HW, TEXT_LEN = 2, 3, (64, 96), 8


def model_inputs(seed: int = 0) -> Dict[str, np.ndarray]:
    """Inputs of the tiny model: B = 2 clips of T = 3 frames at 64x96, the
    second clip padded (valid ratios < 1) with a shorter caption."""
    rng = np.random.RandomState(seed)
    h, w = HW
    video = rng.randn(B, T, h, w, 3).astype(np.float32)
    video_mask = np.zeros((B, T, h, w), bool)
    video_mask[1, :, 56:, :] = True       # a padded clip: valid ratios < 1
    video_mask[1, :, :, 80:] = True
    text_ids = rng.randint(3, 50000, (B, TEXT_LEN)).astype(np.int32)
    text_attn = np.ones((B, TEXT_LEN), np.int32)
    text_attn[1, 5:] = 0
    text_ids[1, 5:] = 1
    sizes = np.asarray([[h, w], [56, 80]], np.int32)
    return dict(video=video, video_mask=video_mask, text_ids=text_ids,
                text_attn_mask=text_attn, sizes=sizes)


def _leaf(path: str, shape, rng: np.random.RandomState) -> np.ndarray:
    name = path.rsplit("/", 1)[-1]
    if name == "running_var":
        x = 0.5 + rng.rand(*shape)
    elif name == "scale" or (path.startswith("frozen/") and name == "weight"):
        x = 1.0 + 0.1 * rng.randn(*shape)
    elif name in ("bias", "running_mean"):
        x = 0.1 * rng.randn(*shape)
    elif name == "kernel":
        x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "embedding":
        x = 0.5 * rng.randn(*shape)
    else:  # query_embed, level_embed, memory_bus, memory_pos
        x = rng.randn(*shape)
    return x.astype(np.float32)


def random_variables(init_fn, *args, seed: int = 0, **kwargs) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Variables with the structure ``init_fn`` would make (traced only,
    never compiled) and seeded random values. Returns (variables,
    flat numpy dict with "/" keys)."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args, **kwargs)
    flat_shapes = traverse_util.flatten_dict(shapes, sep="/")
    rng = np.random.RandomState(seed)
    flat = {k: _leaf(k, flat_shapes[k].shape, rng) for k in sorted(flat_shapes)}
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return variables, flat


def prefixed(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Give a sub-module's variables the path they have inside the full
    model: "params/x" -> "params/<prefix>/x"."""
    out = {}
    for k, v in flat.items():
        col, _, rest = k.partition("/")
        out[f"{col}/{prefix}/{rest}"] = v
    return out


def sub_state_dict(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` under ``prefix.``, with the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def assert_close(got, want, rtol: float, atol: float, name: str = "") -> None:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def tiny_model(variant: str):
    """The JAX tiny model of ``VARIANTS[variant]`` (``msda_impl="xla"``),
    seeded variables (traced, never compiled) and the inputs:
    (jax config, model, variables, flat numpy variables, inputs)."""
    jcfg = JaxModelConfig(**VARIANTS[variant], binary=True, msda_impl="xla")
    model = jax_build_model(jcfg)
    inputs = model_inputs()
    variables, flat = random_variables(model.init, **{k: jnp.asarray(v) for k, v in inputs.items()})
    return jcfg, model, variables, flat, inputs


# ---- the training slice: two train steps against the JAX package ------------------

SLICE_TOL = 2e-3  # the model-level bar of the JAX package's parity with the reference


def random_boxes(rng, *shape):
    """cxcywh boxes inside the unit square, some overlapping, some not."""
    c = rng.rand(*shape, 2) * 0.6 + 0.2
    wh = rng.rand(*shape, 2) * 0.35 + 0.05
    return np.concatenate([c, wh], -1).astype(np.float32)


def train_targets(seed=0):
    """Targets of ``model_inputs``' two clips, one frame of clip 0 invalid."""
    rng = np.random.RandomState(seed)
    b, t, (h, w) = B, T, HW
    valid = np.ones((b, t), np.int32)
    valid[0, 2] = 0
    return {"labels": np.zeros((b, t), np.int32), "boxes": random_boxes(rng, b, t),
            "masks": (rng.rand(b, t, h, w) > 0.5).astype(np.float32), "valid": valid}


def jax_train_steps(tiny, tcfg, targets, n_steps):
    """Per step: (losses, grad norm, grads, params after), as numpy with the
    port's names and layouts. The JAX package's ``make_train_step`` always
    draws dropout, so the loss is built here from ``model.apply(...,
    deterministic=True)`` and ``criterion``."""
    jcfg, model, variables, _, inputs = tiny
    params = variables["params"]
    frozen = {k: v for k, v in variables.items() if k != "params"}
    crit = jax_criterion_from_configs(jcfg, tcfg)
    j_inputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    j_targets = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(p):
        out = model.apply({"params": p, **frozen}, **j_inputs, deterministic=True)
        losses = jax_criterion(crit, out, j_targets)
        return sum(losses.values()), losses

    tx = jax_ts.make_optimizer(params, tcfg, steps_per_epoch=1)

    @jax.jit  # one compile for the whole step: eager optax ops compile per leaf shape
    def jax_step(params, opt_state):
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (losses, optax.global_norm(grads), grads, optax.apply_updates(params, updates),
                opt_state)

    def port_layout(tree):
        flat = traverse_util.flatten_dict(tree, sep="/")
        return {k: v.numpy() for k, v in state_dict_from_jax(
            {f"params/{k}": np.array(v) for k, v in flat.items()}).items()}

    opt_state = jax.jit(tx.init)(params)
    steps = []
    for _ in range(n_steps):
        losses, gnorm, grads, params, opt_state = jax_step(params, opt_state)
        steps.append(({k: float(v) for k, v in losses.items()}, float(gnorm),
                      port_layout(grads), port_layout(params)))
    return steps


def check_two_train_steps(variant: str) -> None:
    """Two steps of the port's ``make_train_step`` on the tiny model of
    ``VARIANTS[variant]`` (f32, dropout off) against ``jax.value_and_grad``
    of the JAX model's loss and the optax chain of ``make_optimizer``, from
    the same weights and batch.

    Losses and the pre-clip grad norm at 2e-3. Each parameter's (clipped)
    gradient: its difference within 2e-3 of the tensor's gradient in L2
    norm, and every element within 2e-4 of the largest |grad| of the whole
    model. (Element-wise against each tensor's own largest |grad|, as the
    losses are held, a few backbone convolutions miss by up to 1.2%: on
    random weights some pre-ReLU activations lie within f32 rounding of
    zero, so the two frameworks let a few different elements through, and
    those weights' gradients cancel to under 1% of the model's largest.)
    A gradient that is zero in exact arithmetic (the text encoder's key
    biases: softmax ignores a constant added to a row of logits) is f32
    noise on both sides and is held below 1e-6 of the model's largest.
    After each step: where the JAX gradient is above 1% of its tensor's
    largest, the parameter at rtol 1e-3, plus half of the tier's LR for
    parameters near zero (Adam divides by the gradient's running RMS, so
    in the second step the few backbone elements that the ReLU flips above
    touch move by up to 0.22 of an LR step more or less); elsewhere
    Adam's step can take either sign, and
    the port's step must stay within the tier's LR times (1 + wd |p|), 1%
    over for Adam's second-step ratio, plus two f32 spacings of |p| for the
    rounding of the parameter.
    The second step crosses the MultiStep drop (``lr_drop=(1,)``, one step
    per epoch); it starts from the JAX parameters after the first step, with
    the port's own optimizer state, so that it is compared from the same
    point (Adam's first step takes either sign where a gradient is near zero,
    and the second step's gradients would be taken at other parameters)."""
    tiny = tiny_model(variant)
    _, _, _, flat, inputs = tiny
    kw = dict(lr_drop=(1,))
    targets = train_targets()
    want = jax_train_steps(tiny, JaxTrainConfig(**kw), targets, n_steps=2)

    tcfg = TrainConfig(**kw)
    cfg = ModelConfig(**VARIANTS[variant])
    port = ReferFormer(cfg)
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    port.eval()  # dropout off
    state = train_step.create_train_state(port, tcfg, steps_per_epoch=1)
    step = train_step.make_train_step(criterion_from_configs(cfg, tcfg))
    tiers = {name: train_step.param_group(name, tcfg) for name, _ in port.named_parameters()}
    lr0 = {"base": tcfg.lr, "backbone": tcfg.lr_backbone, "text_encoder": tcfg.lr_text_encoder,
           "linear_proj": tcfg.lr * tcfg.lr_linear_proj_mult}
    batch = dict(inputs, targets=targets)
    for k, (losses, gnorm, grads, params_after) in enumerate(want):
        before = {n: p.detach().clone() for n, p in port.named_parameters()}
        state, metrics = step(state, batch)
        assert metrics["lr"] == pytest.approx(tcfg.lr * 0.1 ** k, rel=1e-6)
        assert sorted(k_ for k_ in metrics if k_.startswith("loss_")) == sorted(losses)
        for name, v in losses.items():
            assert_close(metrics[name], v, rtol=SLICE_TOL, atol=SLICE_TOL, name=f"step {k} {name}")
        assert_close(metrics["grad_norm"], gnorm, rtol=SLICE_TOL, atol=0, name="grad_norm")
        clip = min(1.0, tcfg.clip_max_norm / gnorm)
        g_all = max(float(np.abs(g).max()) for g in grads.values()) * clip
        for name, p in port.named_parameters():
            g_want, g_got = grads[name] * clip, p.grad.numpy()
            g_scale = float(np.abs(g_want).max())
            where = f"step {k} grad {name}"
            if g_scale < 1e-6 * g_all:  # zero in exact arithmetic
                assert float(np.abs(g_got).max()) < 1e-6 * g_all, where
            else:
                assert np.linalg.norm(g_got - g_want) <= SLICE_TOL * np.linalg.norm(g_want), where
                assert_close(g_got, g_want, rtol=0, atol=0.1 * SLICE_TOL * g_all, name=where)
            lr = lr0[tiers[name]] * 0.1 ** k
            strong = np.abs(grads[name]) > 0.01 * np.abs(grads[name]).max()
            strong &= g_scale >= 1e-6 * g_all
            new, old = p.detach().numpy(), before[name].numpy()
            np.testing.assert_allclose(new[strong], params_after[name][strong], rtol=1e-3,
                                       atol=0.5 * lr, err_msg=f"step {k} param {name}")
            weak = np.abs(old[~strong])
            bound = 1.01 * lr * (1 + tcfg.weight_decay * weak) + 2 * np.spacing(weak)
            assert (np.abs(new - old)[~strong] <= bound).all(), f"step {k} param {name}"
        with torch.no_grad():  # the next step starts where the JAX one does
            for name, p in port.named_parameters():
                p.copy_(torch.from_numpy(params_after[name]))
    assert state.step == 2
