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
from tce_rvos_tpu.parallel.flat_adamw import make_flat_adamw_fused
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


# tests/test_checkpoint.py's TINY (binary: one class logit) plus the
# flagship's switches, or without them: the plain ReferFormer
TINY = dict(enc_layers=2, dec_layers=2, dim_feedforward=64,
            text_encoder_layers=2, text_encoder_hidden=64,
            text_encoder_heads=4, text_encoder_intermediate=128, binary=True)
VARIANTS = {"flagship": dict(TINY, f_token=2, qtrans=True, with_box_refine=True),
            "plain": TINY}
FLAGSHIP_TINY = VARIANTS["flagship"]
# the flagship with temporal MSDA in the encoder and decoder (--msda_3d)
VARIANTS["flagship_3d"] = FLAGSHIP_3D_TINY = dict(FLAGSHIP_TINY, msda_3d=True)
# the clips of the Video-Swin-T model's two train steps (the default seed 0's
# are ill-conditioned in f32 there: tests/test_torch_train_swin.py)
SWIN_STEP_SEED = 2
# the clips of configuration (A)'s train steps (OPTIONS_A below): the first
# whose forward has no ReLU input of another sign in f32 than in float64.
# On seed 0's clips three do, one in encoder layer 0's FFN, where the port's
# f32 gradient lies 9.8e-4 of its norm from float64 and JAX's 5e-7, and the
# backbone's gradients 2.8e-3 from JAX's; seeds 1-3 have two each, and a
# backbone gradient misses the L2 or element limit at one of the two steps
# (tests/test_torch_slice_options.py holds the premise)
OPTIONS_STEP_SEED = 4
# the flagship on the other backbone families (full-width backbones)
VARIANTS.update({f"flagship_{short}": dict(FLAGSHIP_TINY, backbone=name) for short, name in (
    ("video_swin", "video_swin_t_p4w7"), ("swin", "swin_t_p4w7"), ("x3d", "x3d_s"))})
# the model options in two combinations: (A) LastLayerAsToken (f_token -1),
# IQT, box refinement, ytvos's 65 classes, the visibility heads and the
# contrastive output; (B) no V-L blocks, no relative coordinates, no box
# refinement, davis's 78 classes, FTF with 2 tokens; (A) without the mask
# losses and costs (``--masks`` not given)
OPTIONS_A = VARIANTS["options_a"] = dict(
    TINY, binary=False, dataset_file="ytvos", f_token=-1, qtrans=True, with_box_refine=True,
    vis_loss=True, contrastive=True)
OPTIONS_B = VARIANTS["options_b"] = dict(
    TINY, binary=False, dataset_file="davis", vlblock=False, rel_coord=False, f_token=2)
VARIANTS["options_a_nomasks"] = dict(OPTIONS_A, masks=False)
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
    if name in ("running_var", "var"):  # var: X3D's BatchNorm (batch_stats)
        x = 0.5 + rng.rand(*shape)
    elif name == "scale" or (path.startswith("frozen/") and name == "weight"):
        x = 1.0 + 0.1 * rng.randn(*shape)
    elif name in ("bias", "running_mean", "mean"):
        x = 0.1 * rng.randn(*shape)
    elif name == "kernel":
        x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "embedding":
        x = 0.5 * rng.randn(*shape)
    else:  # query_embed, level_embed, memory_bus, memory_pos, Swin bias tables
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
    jcfg = JaxModelConfig(**VARIANTS[variant], msda_impl="xla")
    model = jax_build_model(jcfg)
    inputs = model_inputs()
    variables, flat = random_variables(model.init, **{k: jnp.asarray(v) for k, v in inputs.items()})
    return jcfg, model, variables, flat, inputs


SLICE_TOL = 2e-3  # the model-level bar of the JAX package's parity with the reference


def check_forward_matches_jax(variant: str) -> None:
    """The port's forward of the tiny model of ``VARIANTS[variant]`` against
    the JAX model's on its inputs, every output at SLICE_TOL."""
    _, model, variables, flat, inputs = tiny_model(variant)
    want = jax.jit(model.apply)(variables, **{k: jnp.asarray(v) for k, v in inputs.items()})
    port = ReferFormer(ModelConfig(**VARIANTS[variant]))
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    with torch.inference_mode():
        got = port.eval()(
            torch.from_numpy(inputs["video"]), torch.from_numpy(inputs["video_mask"]),
            torch.from_numpy(inputs["text_ids"]).long(),
            torch.from_numpy(inputs["text_attn_mask"]).long(),
            torch.from_numpy(inputs["sizes"]).long())
    for k in ("pred_logits", "pred_boxes", "pred_masks", "reference_points",
              "inter_samples", "memory"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert_close(got[k], want[k], rtol=SLICE_TOL, atol=SLICE_TOL, name=k)


def engine_pair(variant: str = "flagship", **engine_kw):
    """The JAX package's and the port's ``InferenceEngine`` (CPU) on the
    shared weights of the tiny model of ``VARIANTS[variant]``."""
    from tce_rvos_tpu.infer import InferenceEngine as JaxInferenceEngine
    from tce_rvos_tpu_torch.infer import InferenceEngine

    jcfg, _, variables, flat, _ = tiny_model(variant)
    return (JaxInferenceEngine(jcfg, variables, **engine_kw),
            InferenceEngine(ModelConfig(**VARIANTS[variant]), state_dict_from_jax(flat),
                            device="cpu", **engine_kw))


# ---- the training slice: two train steps against the JAX package ------------------


def random_boxes(rng, *shape):
    """cxcywh boxes inside the unit square, some overlapping, some not."""
    c = rng.rand(*shape, 2) * 0.6 + 0.2
    wh = rng.rand(*shape, 2) * 0.35 + 0.05
    return np.concatenate([c, wh], -1).astype(np.float32)


def train_targets(seed=0, num_classes: int = 1):
    """Targets of ``model_inputs``' two clips, one frame of clip 0 invalid;
    with ``num_classes`` > 1, each clip's object of a random class."""
    rng = np.random.RandomState(seed)
    b, t, (h, w) = B, T, HW
    valid = np.ones((b, t), np.int32)
    valid[0, 2] = 0
    out = {"labels": np.zeros((b, t), np.int32), "boxes": random_boxes(rng, b, t),
           "masks": (rng.rand(b, t, h, w) > 0.5).astype(np.float32), "valid": valid}
    if num_classes > 1:
        out["labels"] += rng.randint(0, num_classes, (b, 1)).astype(np.int32)
    return out


def jax_train_steps(tiny, tcfg, targets, n_steps, inputs=None):
    """Per step: (losses, grad norm, grads, params after), as numpy with the
    port's names and layouts, on ``inputs`` (the tiny model's own unless
    given) and ``targets``, with ``tcfg``'s optimizer: the fused flat AdamW
    (``make_flat_adamw_fused``) when ``tcfg.flat_opt``, else the optax chain
    of ``make_optimizer``. The JAX package's ``make_train_step`` always
    draws dropout, so the loss is built here from ``model.apply(...,
    deterministic=True)`` and ``criterion``."""
    return jax_train_runs(tiny, [tcfg], targets, n_steps, inputs)[0]


def jax_train_runs(tiny, tcfgs, targets, n_steps, inputs=None):
    """``jax_train_steps`` for each config of ``tcfgs`` (which differ in
    their optimizer only), the gradient compiled once."""
    jcfg, model, variables, _, own_inputs = tiny
    inputs = own_inputs if inputs is None else inputs
    params = variables["params"]
    frozen = {k: v for k, v in variables.items() if k != "params"}
    crit = jax_criterion_from_configs(jcfg, tcfgs[0])
    j_inputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    j_targets = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(p):
        out = model.apply({"params": p, **frozen}, **j_inputs, deterministic=True)
        losses = jax_criterion(crit, out, j_targets)
        return sum(losses.values()), losses

    def optimizer(tcfg):
        """(init, update(grads, opt_state, params) -> (grad norm, params,
        opt_state)) of ``tcfg``'s optimizer."""
        if tcfg.flat_opt:
            tx = make_flat_adamw_fused(params, tcfg, steps_per_epoch=1)

            def update(grads, opt_state, params):
                params, opt_state = tx.apply_params(grads, opt_state, params)
                return opt_state.gnorm, params, opt_state
        else:
            tx = jax_ts.make_optimizer(params, tcfg, steps_per_epoch=1)

            def update(grads, opt_state, params):
                updates, opt_state = tx.update(grads, opt_state, params)
                return optax.global_norm(grads), optax.apply_updates(params, updates), opt_state
        return tx.init, update

    # jitted, as eager optax ops compile per leaf shape; the gradient and the
    # updates compile at once in threads (XLA releases the GIL)
    txs = [optimizer(tcfg) for tcfg in tcfgs]
    with ThreadPoolExecutor(1 + len(txs)) as pool:
        grad_fn = pool.submit(
            lambda: jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(params).compile())
        update_fns = [pool.submit(lambda init=init, update=update: jax.jit(update).lower(
            params, jax.eval_shape(init, params), params).compile()) for init, update in txs]
        grad_fn, update_fns = grad_fn.result(), [f.result() for f in update_fns]

    def port_layout(tree):
        flat = traverse_util.flatten_dict(tree, sep="/")
        return {k: v.numpy() for k, v in state_dict_from_jax(
            {f"params/{k}": np.array(v) for k, v in flat.items()}).items()}

    runs = []
    for (init, _), update_fn in zip(txs, update_fns):
        p, opt_state = params, jax.jit(init)(params)
        steps = []
        for _ in range(n_steps):
            (_, losses), grads = grad_fn(p)
            gnorm, p, opt_state = update_fn(grads, opt_state, p)
            steps.append(({k: float(v) for k, v in losses.items()}, float(gnorm),
                          port_layout(grads), port_layout(p)))
        runs.append(steps)
    return runs


def check_two_train_steps(variant: str, batch=None, jax_batch=None, n_steps: int = 2,
                          flat_opt: bool = False, want=None) -> None:
    """Two steps (or ``n_steps``) of the port's ``make_train_step`` on the
    tiny model of ``VARIANTS[variant]`` (f32, dropout off) against
    ``jax.value_and_grad`` of the JAX model's loss and the JAX optimizer of
    the same ``flat_opt``: by default the port's ``--no-flat_opt`` AdamW
    against the optax chain of ``make_optimizer``, as these tests held it
    before the flat AdamW; with ``flat_opt=True`` the port's ``FlatAdamW``
    against ``make_flat_adamw_fused``; from the same weights,
    on ``batch`` (model inputs and ``targets``; by default the tiny model's
    inputs and ``train_targets()``), the JAX side on ``jax_batch`` if given
    (or its steps ``want``, ``jax_train_steps``' result, if given). The
    flat AdamW leaves its gradient buffer unclipped: its gradients are
    held times the clip's factor.

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
    kw = dict(lr_drop=(1,), flat_opt=flat_opt)
    if batch is None:
        batch = dict(inputs, targets=train_targets())
    jax_batch = batch if jax_batch is None else jax_batch
    jax_inputs = {k: v for k, v in jax_batch.items() if k in inputs}
    # the JAX steps (mostly XLA's compile, which releases the GIL) in a
    # thread, while the port builds its model and takes its first step
    jax_steps = ThreadPoolExecutor(1)
    if want is None:
        want = jax_steps.submit(jax_train_steps, tiny, JaxTrainConfig(**kw),
                                jax_batch["targets"], n_steps, jax_inputs)
    else:
        want = jax_steps.submit(lambda: want)

    tcfg = TrainConfig(**kw)
    cfg = ModelConfig(**VARIANTS[variant])
    port = ReferFormer(cfg)
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    port.eval()  # dropout off
    state = train_step.create_train_state(port, tcfg, steps_per_epoch=1)
    step = train_step.make_train_step(criterion_from_configs(cfg, tcfg))
    for k in range(n_steps):
        before = {n: p.detach().numpy().copy() for n, p in port.named_parameters()}
        state, metrics = step(state, batch)
        if k == 0:
            want = want.result()
            jax_steps.shutdown()
        scale = float(state.optimizer.unapplied_clip())
        check_step_against_jax(
            k, metrics, {n: p.grad.numpy() * scale for n, p in port.named_parameters()}, before,
            {n: p.detach().numpy() for n, p in port.named_parameters()}, want[k], tcfg)
        with torch.no_grad():  # the next step starts where the JAX one does
            for name, p in port.named_parameters():
                p.copy_(torch.from_numpy(want[k][3][name]))
    assert state.step == n_steps


def check_step_against_jax(k: int, metrics, grads, before, after, want, tcfg) -> None:
    """Step ``k`` of the port (its metrics, and per parameter name its
    clipped gradient and its values before and after the step, numpy)
    against the JAX step ``want`` (an entry of ``jax_train_steps``), as
    ``check_two_train_steps`` holds it."""
    tiers = {name: train_step.param_group(name, tcfg) for name in grads}
    lr0 = {"base": tcfg.lr, "backbone": tcfg.lr_backbone, "text_encoder": tcfg.lr_text_encoder,
           "linear_proj": tcfg.lr * tcfg.lr_linear_proj_mult}
    losses, gnorm, want_grads, params_after = want
    assert metrics["lr"] == pytest.approx(tcfg.lr * 0.1 ** k, rel=1e-6)
    assert sorted(k_ for k_ in metrics if k_.startswith("loss_")) == sorted(losses)
    for name, v in losses.items():
        assert_close(metrics[name], v, rtol=SLICE_TOL, atol=SLICE_TOL, name=f"step {k} {name}")
    assert_close(metrics["grad_norm"], gnorm, rtol=SLICE_TOL, atol=0, name="grad_norm")
    clip = min(1.0, tcfg.clip_max_norm / gnorm)
    g_all = max(float(np.abs(g).max()) for g in want_grads.values()) * clip
    for name, g_got in grads.items():
        g_want = want_grads[name] * clip
        g_scale = float(np.abs(g_want).max())
        where = f"step {k} grad {name}"
        if g_scale < 1e-6 * g_all:  # zero in exact arithmetic
            assert float(np.abs(g_got).max()) < 1e-6 * g_all, where
        else:
            assert np.linalg.norm(g_got - g_want) <= SLICE_TOL * np.linalg.norm(g_want), where
            assert_close(g_got, g_want, rtol=0, atol=0.1 * SLICE_TOL * g_all, name=where)
        lr = lr0[tiers[name]] * 0.1 ** k
        strong = np.abs(want_grads[name]) > 0.01 * np.abs(want_grads[name]).max()
        strong &= g_scale >= 1e-6 * g_all
        new, old = after[name], before[name]
        assert_close(new[strong], params_after[name][strong], rtol=1e-3, atol=0.5 * lr,
                     name=f"step {k} param {name}")
        weak = np.abs(old[~strong])
        bound = 1.01 * lr * (1 + tcfg.weight_decay * weak) + 2 * np.spacing(weak)
        assert (np.abs(new - old)[~strong] <= bound).all(), f"step {k} param {name}"


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


# ---- synthetic JHMDB-Sentences, RefCOCO and MeViS trees -----------------------------


def _smooth_image(rng, h, w):
    """A smooth random RGB image, uint8 (JPEG-friendly)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.stack([0.5 + 0.5 * np.sin((xx * a + yy * b) / 9.0 + c)
                  for a, b, c in rng.rand(3, 3)], -1)
    return (f * 255).astype(np.uint8)


def write_jhmdb_tree(root, videos=(("pour", "v0", 9), ("pour", "v1", 7)), hw=(48, 64),
                     seed: int = 0):
    """A JHMDB-Sentences root: Rename_Images/<class>/<video>/%05d.png frames
    (1-based), puppet_mask/<class>/<video>/puppet_mask.mat (``part_mask``
    [H, W, T], a person moving a pixel a frame) and
    jhmdb_sentences_samples_metadata.json, two samples a video (annotated
    frames near both ends, so the window is edge-padded). Returns ``root``."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.RandomState(seed)
    h, w = hw
    samples = []
    for cls, vid, n in videos:
        fdir = os.path.join(root, "Rename_Images", cls, vid)
        mdir = os.path.join(root, "puppet_mask", cls, vid)
        os.makedirs(fdir)
        os.makedirs(mdir)
        masks = np.zeros((h, w, n), np.uint8)
        for i in range(n):
            Image.fromarray(_smooth_image(rng, h, w)).save(os.path.join(fdir, f"{i + 1:05d}.png"))
            masks[h // 4 + i: h // 4 + i + h // 2, w // 3 + i: w // 3 + i + w // 4, i] = 1
        savemat(os.path.join(mdir, "puppet_mask.mat"), {"part_mask": masks})
        for frame in (2, n - 1):
            samples.append([f"the man  POURING {vid}", vid,
                            f"Rename_Images/{cls}/{vid}/{frame:05d}.png",
                            f"puppet_mask/{cls}/{vid}/puppet_mask.mat", n])
    with open(os.path.join(root, "jhmdb_sentences_samples_metadata.json"), "w") as fh:
        json.dump(samples, fh)
    return root


def write_refexp_tree(root, names=("refcoco",), splits=("train", "val"), n_images: int = 3,
                      hw=(48, 64), seed: int = 0):
    """A COCO-format refexp root: train2014/*.jpg and
    instances_<name>_<split>.json for each name and split; each image one
    caption and one annotation (a polygon segmentation, the last image's
    touching the frame's right edge at x = W), the first image also a
    second, crowd, annotation. Returns ``root``."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "train2014"), exist_ok=True)
    for name in names:
        for split in splits:
            images, anns = [], []
            for i in range(n_images):
                img_id = 1000 * len(name) + 10 * len(split) + i
                fname = f"COCO_train2014_{img_id:012d}.jpg"
                Image.fromarray(_smooth_image(rng, h, w)).save(
                    os.path.join(root, "train2014", fname))
                images.append({"id": img_id, "file_name": fname, "height": h, "width": w,
                               "caption": f"The {name} thing on the Left {i}"})
                cx, cy = w * (0.3 + 0.4 * rng.rand()), h * (0.3 + 0.4 * rng.rand())
                ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
                r = rng.uniform(0.3, 1.0, 7) * min(h, w) / 3
                poly = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)
                if i == n_images - 1:
                    poly[0] = (w, cy)   # on the right edge: rounds to x = W
                poly = np.clip(poly, 0, [w, h])
                x0, y0 = poly.min(0)
                x1, y1 = poly.max(0)
                anns.append({"id": len(anns), "image_id": img_id, "iscrowd": 0,
                             "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                             "area": float((x1 - x0) * (y1 - y0)) / 2,
                             "segmentation": [poly.ravel().round(2).tolist()]})
                if i == 0:
                    anns.append({"id": len(anns), "image_id": img_id, "iscrowd": 1,
                                 "bbox": [2.0, 3.0, 10.0, 8.0], "area": 80.0,
                                 "segmentation": [[2, 3, 12, 3, 12, 11, 2, 11]]})
            with open(os.path.join(root, f"instances_{name}_{split}.json"), "w") as fh:
                json.dump({"images": images, "annotations": anns}, fh)
    return root


def write_mevis_tree(root, split="train", n_videos: int = 2, n_frames: int = 6, hw=(48, 64),
                     seed: int = 0):
    """A MeViS split under ``root/<split>``: JPEGImages, mask_dict.json
    (RLEs, None where an object is absent) and meta_expressions.json; the
    second expression of a video refers to both objects (the union mask),
    the third to an object absent from most frames. Returns ``root``."""
    from PIL import Image

    from tce_rvos_tpu.utils import rle as jax_rle

    rng = np.random.RandomState(seed)
    h, w = hw
    mask_dict, videos = {}, {}
    for v in range(n_videos):
        vid = f"m{v}"
        os.makedirs(os.path.join(root, split, "JPEGImages", vid))
        frames = [f"{i:05d}" for i in range(n_frames)]
        rles = {str(3 * v + k): [] for k in range(3)}
        for i, f in enumerate(frames):
            Image.fromarray(_smooth_image(rng, h, w)).save(
                os.path.join(root, split, "JPEGImages", vid, f + ".jpg"))
            for k in range(3):
                m = np.zeros((h, w), np.uint8)
                if k == 0:
                    m[5 + i: 20 + i, 4 + 2 * i: 24 + 2 * i] = 1
                elif k == 1:
                    m[h - 18: h - 4, w - 20 - i: w - 6 - i] = 1
                elif i == n_frames - 1:
                    m[2:8, 2:9] = 1
                rles[str(3 * v + k)].append(jax_rle.encode(m) if m.any() else None)
        mask_dict.update(rles)
        videos[vid] = {"frames": frames, "expressions": {
            "0": {"exp": "the Car moving left", "obj_id": [0], "anno_id": [3 * v]},
            "1": {"exp": "two cars", "obj_id": [0, 1], "anno_id": [3 * v, 3 * v + 1]},
            "2": {"exp": "the bird arriving at the end", "obj_id": [2],
                  "anno_id": [3 * v + 2]}}}
    with open(os.path.join(root, split, "mask_dict.json"), "w") as fh:
        json.dump(mask_dict, fh)
    with open(os.path.join(root, split, "meta_expressions.json"), "w") as fh:
        json.dump({"videos": videos}, fh)
    return root
