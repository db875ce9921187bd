"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Weights are made with numpy from a seed and given to both frameworks. Every
leaf gets seeded noise: at the JAX package's own init the MSDA offset and
attention kernels are zero, which makes the attention weights uniform and
the top-k sample export a tie, and the parity tests weak.
"""

from __future__ import annotations

import functools
import json
import os
from concurrent.futures import ThreadPoolExecutor
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


# The test run gives each of several workers a process on one host, and
# torch's OpenMP pool of one thread per core in each of them spins at every
# op's barrier: with the pools oversubscribed, most of the host's time went
# to spinning (the port's test files took 3.4x as long under 6 workers as
# with 2 threads a worker). Each port test module runs with at most
# TORCH_THREADS and gives the worker back its count afterwards.
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """At most TORCH_THREADS torch threads while the importing test module
    runs (import it into the module for it to apply)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)


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
    want = np.asarray(want, np.float32)
    # numpy's own check only where the quick one fails (it is slow, and the
    # two-step checks call this for every parameter): it decides and reports
    if got.shape != want.shape or not (np.abs(got - want) <= atol + rtol * np.abs(want)).all():
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


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


SLICE_TOL = 2e-3  # the model-level bar of the JAX package's parity with the reference


def engine_pair(**engine_kw):
    """The JAX package's and the port's ``InferenceEngine`` (CPU) on the
    tiny flagship's shared weights."""
    from tce_rvos_tpu.infer import InferenceEngine as JaxInferenceEngine
    from tce_rvos_tpu_torch.infer import InferenceEngine

    jcfg, _, variables, flat, _ = tiny_model("flagship")
    return (JaxInferenceEngine(jcfg, variables, **engine_kw),
            InferenceEngine(ModelConfig(**FLAGSHIP_TINY), state_dict_from_jax(flat),
                            device="cpu", **engine_kw))


# ---- the training slice: two train steps against the JAX package ------------------


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


def jax_train_steps(tiny, tcfg, targets, n_steps, inputs=None):
    """Per step: (losses, grad norm, grads, params after), as numpy with the
    port's names and layouts, on ``inputs`` (the tiny model's own unless
    given) and ``targets``. The JAX package's ``make_train_step`` always
    draws dropout, so the loss is built here from ``model.apply(...,
    deterministic=True)`` and ``criterion``."""
    jcfg, model, variables, _, own_inputs = tiny
    inputs = own_inputs if inputs is None else inputs
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

    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.global_norm(grads), optax.apply_updates(params, updates), opt_state

    # jitted, as eager optax ops compile per leaf shape; the gradient and the
    # update compile at once in two threads (XLA releases the GIL)
    opt_shapes = jax.eval_shape(tx.init, params)
    with ThreadPoolExecutor(2) as pool:
        grad_fn = pool.submit(
            lambda: jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(params).compile())
        update_fn = pool.submit(
            lambda: jax.jit(update).lower(params, opt_shapes, params).compile())
        grad_fn, update_fn = grad_fn.result(), update_fn.result()

    def jax_step(params, opt_state):
        (_, losses), grads = grad_fn(params)
        gnorm, params, opt_state = update_fn(grads, opt_state, params)
        return losses, gnorm, grads, params, opt_state

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


def check_two_train_steps(variant: str, batch=None, jax_batch=None, n_steps: int = 2) -> None:
    """Two steps (or ``n_steps``) of the port's ``make_train_step`` on the
    tiny model of ``VARIANTS[variant]`` (f32, dropout off) against
    ``jax.value_and_grad`` of the JAX model's loss and the optax chain of
    ``make_optimizer``, from the same weights, on ``batch`` (model inputs
    and ``targets``; by default the tiny model's inputs and
    ``train_targets()``), the JAX side on ``jax_batch`` if given.

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
    if batch is None:
        batch = dict(inputs, targets=train_targets())
    jax_batch = batch if jax_batch is None else jax_batch
    jax_inputs = {k: v for k, v in jax_batch.items() if k in inputs}
    # the JAX steps (mostly XLA's compile, which releases the GIL) in a
    # thread, while the port builds its model and takes its first step
    jax_steps = ThreadPoolExecutor(1)
    want = jax_steps.submit(jax_train_steps, tiny, JaxTrainConfig(**kw), jax_batch["targets"],
                            n_steps, jax_inputs)

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
    for k in range(n_steps):
        before = {n: p.detach().clone() for n, p in port.named_parameters()}
        state, metrics = step(state, batch)
        if k == 0:
            want = want.result()
            jax_steps.shutdown()
        losses, gnorm, grads, params_after = want[k]
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
            assert_close(new[strong], params_after[name][strong], rtol=1e-3, atol=0.5 * lr,
                         name=f"step {k} param {name}")
            weak = np.abs(old[~strong])
            bound = 1.01 * lr * (1 + tcfg.weight_decay * weak) + 2 * np.spacing(weak)
            assert (np.abs(new - old)[~strong] <= bound).all(), f"step {k} param {name}"
        with torch.no_grad():  # the next step starts where the JAX one does
            for name, p in port.named_parameters():
                p.copy_(torch.from_numpy(params_after[name]))
    assert state.step == n_steps


# ---- synthetic Ref-YouTube-VOS train trees ------------------------------------------


def write_ytvos_tree(root, n_videos: int = 2, n_frames: int = 6, hw=(48, 64),
                     second_object: bool = False, seed: int = 0):
    """A Ref-YouTube-VOS train split under ``root`` (tests/test_data.py's
    layout): random JPEG frames, palette PNG annotations, meta.json and
    meta_expressions. Object 2 ("the cat on the left") moves a pixel a frame
    and is in every frame. ``second_object`` adds object 3 ("the dog on the
    right"), present only in the last two frames of the first video and in
    no frame of the others, so clips with valid = 0 frames and the
    resample-on-empty loop both occur. Returns ``root``."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = hw
    meta, meta_exp = {"videos": {}}, {"videos": {}}
    palette = [c for i in range(256) for c in (i, i, i)]
    for v in range(n_videos):
        vid = f"vid_{v}"
        frames = [f"{i:05d}" for i in range(n_frames)]
        for sub in ("JPEGImages", "Annotations"):
            os.makedirs(os.path.join(root, "train", sub, vid))
        for i, f in enumerate(frames):
            img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, "train", "JPEGImages", vid, f + ".jpg"))
            mask = np.zeros((h, w), np.uint8)
            mask[h // 5 + i: h // 5 + i + h // 3, w // 4 + 2 * i: w // 4 + 2 * i + w // 4] = 2
            if second_object and v == 0 and i >= n_frames - 2:
                mask[h - 12: h - 4, w - 16: w - 6] = 3
            pal = Image.fromarray(mask, mode="P")
            pal.putpalette(palette)
            pal.save(os.path.join(root, "train", "Annotations", vid, f + ".png"), bits=8)
        objects = {"2": {"category": "cat"}}
        exps = {"0": {"exp": "the cat on the left", "obj_id": "2"}}
        if second_object:
            objects["3"] = {"category": "dog"}
            exps["1"] = {"exp": "The  dog on the RIGHT", "obj_id": "3"}
        meta["videos"][vid] = {"objects": objects}
        meta_exp["videos"][vid] = {"frames": frames, "expressions": exps}
    with open(os.path.join(root, "train", "meta.json"), "w") as fh:
        json.dump(meta, fh)
    os.makedirs(os.path.join(root, "meta_expressions", "train"))
    with open(os.path.join(root, "meta_expressions", "train", "meta_expressions.json"),
              "w") as fh:
        json.dump(meta_exp, fh)
    return root
