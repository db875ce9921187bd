"""The port's fused flat AdamW (``tce_rvos_tpu_torch/parallel/flat_adamw.py``)
on the CPU, held against the JAX package's ``make_flat_adamw_fused`` and
``make_flat_adamw`` (the counterparts of ``tests/test_flat_adamw.py``'s
cases), against the port's own ``--no-flat_opt`` AdamW, and on the
storage it keeps:

* six updates from seeded gradients on a tiny model with a parameter in
  every tier (two encoder-owned ones that stay live under
  ``--pretrain_enc``): MultiStep across a drop, the Cyclic triangle, the
  gradient norm below and above ``clip_max_norm``, ``--pretrain_enc``,
  ``freeze_text_encoder`` and a weight decay of 0.1 (at the default the
  decay term is below ``PARAM_TOL``). Parameters within ``PARAM_TOL`` = 1e-7
  absolute (parameters of about 0.1, as ``test_torch_checkpoint.py``'s,
  move by up to 1e-4 a step; the two sides round a few operations
  otherwise), each parameter's ``mu`` and ``nu``
  (mapped through each side's layout) within 1e-6 of the parameter's
  largest, ``gnorm`` within 1e-6 relative,
  ``count`` and ``sched`` exact;
* the frozen tier bitwise fixed with no moments stored, the frozen text
  encoder without weight decay, a seeded resume against the JAX
  ``seed_schedule_step``, the refusal of another layout's state both ways
  (naming the flag), the state's checkpoint round trip bitwise;
* parameters and gradients as views of the flat buffers after
  ``create_train_state``, after ``load_state_dict`` and after an f32 and a
  bf16 backward through the tiny flagship, each at an ``ALIGN`` boundary
  (the layout is the JAX one's but for that padding), a detached ``.grad``
  pointed back by the step and one replaced after its ``zero_grad``
  refused, a ``model.pt`` as large as the per-leaf save's (and a partial
  state dict without the buffer), and no host sync in the update.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from torch import nn

from tce_rvos_tpu.config import TrainConfig as JaxTrainConfig
from tce_rvos_tpu.parallel import train_step as jax_ts
from tce_rvos_tpu.parallel.flat_adamw import _layout, make_flat_adamw, make_flat_adamw_fused
from tce_rvos_tpu_torch.config import ModelConfig, TrainConfig
from tce_rvos_tpu_torch.models.build import build_model
from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
from tce_rvos_tpu_torch.parallel import flat_adamw, train_step
from tce_rvos_tpu_torch.train import restore_train_state
from tce_rvos_tpu_torch.utils.native_ckpt import load_checkpoint, save_checkpoint
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import FLAGSHIP_TINY, model_inputs, train_targets

PARAM_TOL = 1e-7
MOMENT_RTOL = 1e-6
SPE, N_STEPS = 2, 6  # steps 0-5 cross the drops at steps 2 and 6 (lr_drop (1, 3)) once


class FlatTiers(nn.Module):
    """A parameter pair in each tier, named so that both packages put it in
    the same one: backbone.0 (backbone), text_encoder, reference_points
    (linear_proj), head (base), and under transformer.encoder the
    encoder-owned ``encoder_layers_0`` sampling offsets (linear_proj) and
    FFN (base) and the ``memory_bus`` (base), live under --pretrain_enc."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.backbone = nn.ModuleList([nn.Linear(3, 4)])
        self.text_encoder = nn.Linear(4, 2)
        self.transformer = nn.Module()
        self.transformer.reference_points = nn.Linear(4, 2)
        self.transformer.head = nn.Linear(4, 3)
        self.transformer.encoder = nn.Module()
        layer = nn.Module()
        layer.sampling_offsets = nn.Linear(4, 8)
        layer.ffn = nn.Linear(4, 5)
        self.transformer.encoder.encoder_layers_0 = layer
        self.transformer.encoder.memory_bus = nn.Parameter(torch.zeros(2, 4))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))


def _jax_params(model):
    """The model's parameters as a JAX tree with its names' paths (copied:
    the port updates its parameters in place)."""
    return traverse_util.unflatten_dict(
        {tuple(n.split(".")): jnp.array(p.detach().numpy(), copy=True)
         for n, p in model.named_parameters()})


def _grad_seq(model, scale: float, seed: int = 1):
    rng = np.random.default_rng(seed)
    return [{n: (rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32)
             for n, p in model.named_parameters()} for _ in range(N_STEPS)]


def _set_grads(model, grads) -> None:
    """The gradients into ``p.grad``: into the flat buffer's views where
    they are attached, else as new tensors."""
    for name, p in model.named_parameters():
        g = torch.from_numpy(grads[name])
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)


def _jax_tree(grads):
    return traverse_util.unflatten_dict(
        {tuple(n.split(".")): jnp.asarray(g) for n, g in grads.items()})


def _flat_of(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep=".").items()}


def _per_leaf(vec, names, offsets, sizes, shapes, frozen_len):
    """A live-width moment vector cut into each live parameter's values."""
    out = {}
    for n, o, sz, sh in zip(names, offsets, sizes, shapes):
        if o >= frozen_len and sz:
            out[n] = np.asarray(vec)[o - frozen_len:o - frozen_len + sz].reshape(sh)
    return out


def _port_moments(state):
    lay = state.optimizer.layout
    return {k: _per_leaf(getattr(state.optimizer, k).numpy(), lay.names, lay.offsets,
                         lay.sizes, lay.shapes, lay.frozen_len) for k in ("mu", "nu")}


def _jax_moments(jlay, opt_state):
    names = tuple(p.replace("/", ".") for p in jlay.paths)
    return {k: _per_leaf(getattr(opt_state, k), names, jlay.offsets, jlay.sizes, jlay.shapes,
                         jlay.frozen_len) for k in ("mu", "nu")}


def _assert_close_to_leaf(got, want, where):
    """Within MOMENT_RTOL of the leaf's largest |value|: an element where
    b1 * mu and (1 - b1) * g nearly cancel keeps only the rounding of
    either side."""
    np.testing.assert_allclose(got, want, rtol=0, atol=MOMENT_RTOL * float(np.abs(want).max()),
                               err_msg=where)


def _assert_moments(got, want, where):
    assert sorted(got["mu"]) == sorted(want["mu"]), where
    for k in ("mu", "nu"):
        for name, w in want[k].items():
            _assert_close_to_leaf(got[k][name], w, f"{where} {k} {name}")


CASES = {
    "multistep": (dict(lr_drop=(1, 3)), 0.001),   # the norm below clip_max_norm
    "clipped": (dict(lr_drop=(1, 3)), 10.0),      # far above it: clipped every step
    "cyclic": (dict(cyclic_lr=True, cyclic_lr_boundary=(1e-5, 1e-4)), 0.001),
    "pretrain_enc": (dict(pretrain_enc=True, lr_drop=(1, 3)), 10.0),
    "freeze_text": (dict(freeze_text_encoder=True, lr_drop=(1, 3)), 10.0),
    # a weight decay whose term (lr * wd * |p| ~ 1e-6) is ten times PARAM_TOL
    "weight_decay": (dict(weight_decay=0.1, lr_drop=(1, 3)), 10.0),
}


def _tier_of_each_leaf(names, offsets, frozen_len, tier_slices):
    """Each live parameter's (lo, hi, rel) slice, by name."""
    return {n: next(t for t in tier_slices if t[0] <= o - frozen_len < t[1])
            for n, o in zip(names, offsets) if o >= frozen_len}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_matches_jax_fused_and_optax_flat(case):
    kw, scale = CASES[case]
    model = FlatTiers()
    params = _jax_params(model)
    jcfg = JaxTrainConfig(**kw)
    fused, optax_tx = make_flat_adamw_fused(params, jcfg, SPE), make_flat_adamw(params, jcfg, SPE)
    jlay = _layout(params, jcfg, SPE)
    apply = jax.jit(fused.apply_params)
    update = jax.jit(optax_tx.update)
    f_state = fused.init(params)
    o_state, o_params = optax_tx.init(params), params

    state = train_step.create_train_state(model, TrainConfig(**kw), SPE)
    opt = state.optimizer
    assert isinstance(opt, flat_adamw.FlatAdamW)
    lay = opt.layout  # the JAX layout's, each parameter at an ALIGN boundary
    jnames = tuple(p.replace("/", ".") for p in jlay.paths)
    assert lay.names == jnames and lay.sizes == jlay.sizes
    assert [r for _, _, r in lay.tier_slices] == [r for _, _, r in jlay.tier_slices]
    mine = _tier_of_each_leaf(lay.names, lay.offsets, lay.frozen_len, lay.tier_slices)
    theirs = _tier_of_each_leaf(jnames, jlay.offsets, jlay.frozen_len, jlay.tier_slices)
    assert [lay.tier_slices.index(mine[n]) for n in mine] == [
        jlay.tier_slices.index(theirs[n]) for n in mine]
    assert all(o % flat_adamw.ALIGN == 0 for o in lay.offsets + (lay.frozen_len,))
    clipped = []
    for k, grads in enumerate(_grad_seq(model, scale)):
        _set_grads(model, grads)
        gnorm = train_step.apply_gradients(state)
        jg = _jax_tree(grads)
        params, f_state = apply(jg, f_state, params)
        updates, o_state = update(jg, o_state, o_params)
        o_params = optax.apply_updates(o_params, updates)
        clipped.append(float(gnorm) >= lay.clip)
        assert (opt.count, opt.sched, state.step) == (int(f_state.count), int(f_state.sched),
                                                      k + 1)
        assert (int(o_state.count), int(o_state.sched)) == (k + 1, k + 1)
        assert float(gnorm) == pytest.approx(float(f_state.gnorm), rel=MOMENT_RTOL)
        assert float(opt.gnorm) == float(gnorm)
        for want_params, want_state, side in ((params, f_state, "fused"),
                                              (o_params, o_state, "optax")):
            want = _flat_of(want_params)
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                           atol=PARAM_TOL, err_msg=f"{side} step {k} {name}")
            _assert_moments(_port_moments(state), _jax_moments(jlay, want_state),
                            f"{side} step {k}")
    assert all(clipped) if scale > 1 else not any(clipped)


@pytest.mark.parametrize("case", ["multistep", "clipped"])
def test_flat_matches_the_no_flat_opt_adamw(case):
    """The flat update against ``torch.optim.AdamW`` over the tiers (the
    port's ``--no-flat_opt``), from the same weights and gradients: the
    parameters within PARAM_TOL, the moments within 1e-6 relative, the
    same norm. Their per-tier LRs round differently in f32."""
    kw, scale = CASES[case]
    flat, leaf = FlatTiers(), FlatTiers()
    s_flat = train_step.create_train_state(flat, TrainConfig(**kw), SPE)
    s_leaf = train_step.create_train_state(leaf, TrainConfig(flat_opt=False, **kw), SPE)
    assert isinstance(s_leaf.optimizer, torch.optim.AdamW)
    for k, grads in enumerate(_grad_seq(flat, scale)):
        _set_grads(flat, grads)
        _set_grads(leaf, grads)
        g_flat, g_leaf = (train_step.apply_gradients(s) for s in (s_flat, s_leaf))
        assert float(g_flat) == pytest.approx(float(g_leaf), rel=MOMENT_RTOL)
        for (name, p), q in zip(flat.named_parameters(), leaf.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=0,
                                       atol=PARAM_TOL, err_msg=f"step {k} {name}")
        moments = _port_moments(s_flat)
        for (name, _), q in zip(flat.named_parameters(), leaf.parameters()):
            adam = s_leaf.optimizer.state[q]
            for mine, theirs in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                _assert_close_to_leaf(moments[mine][name], adam[theirs].numpy(),
                                      f"step {k} {mine} {name}")


def test_pretrain_enc_keeps_the_frozen_tier_bitwise_and_stores_no_moments():
    model = FlatTiers()
    state = train_step.create_train_state(model, TrainConfig(pretrain_enc=True), SPE)
    lay = state.optimizer.layout
    frozen = [n for n, t in zip(lay.names, lay.tiers) if t == "frozen"]
    live = [n for n, t in zip(lay.names, lay.tiers) if t != "frozen"]
    assert live == ["transformer.encoder.memory_bus",  # base, in named_parameters' order
                    "transformer.encoder.encoder_layers_0.ffn.weight",
                    "transformer.encoder.encoder_layers_0.ffn.bias",
                    "transformer.encoder.encoder_layers_0.sampling_offsets.weight",
                    "transformer.encoder.encoder_layers_0.sampling_offsets.bias"]
    assert lay.names[:len(frozen)] == tuple(frozen)  # the frozen prefix
    assert state.optimizer.mu.numel() == lay.live_total  # the live parameters, aligned
    assert 0 <= lay.live_total - sum(model.get_parameter(n).numel() for n in live) < (
        flat_adamw.ALIGN * len(live))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = _grad_seq(model, 10.0)
    for g in grads:
        _set_grads(model, g)
        gnorm = train_step.apply_gradients(state)
        # the frozen tier's gradients count in the norm
        assert float(gnorm) == pytest.approx(
            float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))),
            rel=1e-6)
    for name in frozen:
        assert torch.equal(model.get_parameter(name).detach(), start[name]), name
    for name in live:
        assert not torch.equal(model.get_parameter(name).detach(), start[name]), name


def test_frozen_text_encoder_gets_no_weight_decay():
    """freeze_text_encoder with zero text-encoder gradients (the model
    stops them): its weights stay bitwise, no decoupled decay."""
    model = FlatTiers()
    state = train_step.create_train_state(model, TrainConfig(freeze_text_encoder=True), SPE)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for g in _grad_seq(model, 1.0):
        g = {n: np.zeros_like(v) if n.startswith("text_encoder.") else v for n, v in g.items()}
        _set_grads(model, g)
        train_step.apply_gradients(state)
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), start[name])
        assert moved != name.startswith("text_encoder."), name


def test_seeded_resume_matches_jax_seed_schedule_step():
    """A weights-only resume at step 3: ``count`` stays 0 and ``sched`` is
    seeded, on both sides; then the updates across the drop at step 6
    match the JAX package's."""
    start, cfg = 3, dict(lr_drop=(1, 3))
    model = FlatTiers()
    params = _jax_params(model)
    fused = make_flat_adamw_fused(params, JaxTrainConfig(**cfg), SPE)
    jstate = jax_ts.seed_schedule_step(
        jax_ts.TrainState(params=params, frozen={}, opt_state=fused.init(params),
                          step=jnp.zeros((), jnp.int32)), start)
    f_state = jstate.opt_state
    state = train_step.seed_schedule_step(
        train_step.create_train_state(model, TrainConfig(**cfg), SPE), start)
    assert (state.optimizer.count, state.optimizer.sched, state.step) == (
        int(f_state.count), int(f_state.sched), int(jstate.step)) == (0, start, start)
    apply = jax.jit(fused.apply_params)
    for k, grads in enumerate(_grad_seq(model, 0.001)):
        _set_grads(model, grads)
        train_step.apply_gradients(state)
        params, f_state = apply(_jax_tree(grads), f_state, params)
        assert (state.optimizer.count, state.optimizer.sched) == (k + 1, start + k + 1)
        want = _flat_of(params)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=PARAM_TOL,
                                       err_msg=f"step {start + k} {name}")


def _trained(tcfg, n: int = 2, seed: int = 0):
    model = FlatTiers(seed)
    state = train_step.create_train_state(model, tcfg, SPE)
    for g in _grad_seq(model, 1.0)[:n]:
        _set_grads(model, g)
        train_step.apply_gradients(state)
    return state


@pytest.mark.parametrize("saved,resumed,match", [
    ("flat", "leaf", "--flat_opt.*--no-flat_opt"),
    ("leaf", "flat", "--no-flat_opt"),
    ("flat", "flat_pretrain_enc", "another layout.*--flat_opt"),
])
def test_the_other_layouts_state_is_refused(tmp_path, saved, resumed, match):
    cfgs = {"flat": TrainConfig(), "leaf": TrainConfig(flat_opt=False),
            "flat_pretrain_enc": TrainConfig(pretrain_enc=True)}
    state = _trained(cfgs[saved])
    save_checkpoint(str(tmp_path / "ck"), state.model.state_dict(), state.optimizer.state_dict(),
                    epoch=0, step=state.step)
    fresh = train_step.create_train_state(FlatTiers(seed=3), cfgs[resumed], SPE)
    with pytest.raises(ValueError, match=match):
        restore_train_state(fresh, str(tmp_path / "ck"), None, SPE)


def test_flat_state_checkpoint_round_trip_is_bitwise(tmp_path):
    state = _trained(TrainConfig(), n=3)
    save_checkpoint(str(tmp_path / "ck"), state.model.state_dict(), state.optimizer.state_dict(),
                    epoch=0, step=state.step)
    _, opt_sd, _ = load_checkpoint(str(tmp_path / "ck"))
    assert opt_sd["flat_adamw"] == state.optimizer.layout.describe()
    resumed, start_epoch = restore_train_state(
        train_step.create_train_state(FlatTiers(seed=5), TrainConfig(), SPE),
        str(tmp_path / "ck"), None, SPE)
    assert start_epoch == 1 and resumed.step == state.step == 3
    a, b = state.optimizer, resumed.optimizer
    assert (a.count, a.sched) == (b.count, b.sched) == (3, 3)
    for k in ("mu", "nu", "gnorm", "params"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for g in _grad_seq(state.model, 1.0, seed=9)[:2]:  # and both go on alike
        for s in (state, resumed):
            _set_grads(s.model, g)
            train_step.apply_gradients(s)
    assert torch.equal(a.params, b.params) and torch.equal(a.nu, b.nu)


# ---- the storage --------------------------------------------------------------------


def _assert_views(state, where: str) -> None:
    opt = state.optimizer
    base_p, base_g = opt.params.data_ptr(), opt.grads.data_ptr()
    for name, o, p in zip(opt.layout.names, opt.layout.offsets,
                          (state.model.get_parameter(n) for n in opt.layout.names)):
        assert p.is_contiguous(), (where, name)
        assert p.data_ptr() == base_p + 4 * o and o % flat_adamw.ALIGN == 0, (where, name)
        assert p.grad is not None and p.grad.data_ptr() == base_g + 4 * o, (where, name)
        assert p.grad.stride() == p.stride(), (where, name)


def _tiny_flagship():
    return build_model(ModelConfig(**FLAGSHIP_TINY), device="cpu", seed=0).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_land_in_the_flat_buffer(dtype):
    """After create_train_state, after load_state_dict and after a backward
    (f32, or bf16 through functional_call's casts): every parameter and
    gradient a view of the flat buffers, and the buffer holds the
    gradients the per-leaf model gets."""
    model, leaf = _tiny_flagship(), _tiny_flagship()
    tcfg = TrainConfig()
    state = train_step.create_train_state(model, tcfg)
    _assert_views(state, "create_train_state")
    model.load_state_dict(leaf.state_dict())
    _assert_views(state, "load_state_dict")
    crit = criterion_from_configs(model.cfg, tcfg)
    batch = train_step.batch_to_device(dict(model_inputs(), targets=train_targets()),
                                       torch.device("cpu"))
    for m in (model, leaf):
        total, _ = train_step.forward_losses(m, batch, crit, dtype)
        total.backward()
    _assert_views(state, f"{dtype} backward")
    assert float(state.optimizer.grads.abs().max()) > 0
    for (name, p), q in zip(model.named_parameters(), leaf.parameters()):
        assert q.grad.dtype == torch.float32
        assert torch.equal(p.grad, q.grad), name


def test_the_step_points_a_detached_grad_back_and_refuses_a_moved_parameter():
    model = _tiny_flagship()
    tcfg = TrainConfig()
    state = train_step.create_train_state(model, tcfg)
    step = train_step.make_train_step(criterion_from_configs(model.cfg, tcfg))
    batch = dict(model_inputs(), targets=train_targets())
    model.zero_grad(set_to_none=True)  # as a caller outside the step may
    state, metrics = step(state, batch)
    _assert_views(state, "after the step")
    assert float(metrics["grad_norm"]) == float(flat_adamw.global_norm(state.optimizer.grads))
    p = model.get_parameter(state.optimizer.layout.names[-1])
    p.data = p.data.clone()
    with pytest.raises(RuntimeError, match="no longer lies in the flat AdamW"):
        step(state, batch)


def test_update_refuses_a_grad_replaced_after_zero_grad():
    """A ``.grad`` replaced between the step's ``zero_grad`` and the update
    (as a hook in the backward could) holds a gradient the buffer lacks:
    the update raises instead of taking zeros for it."""
    model = FlatTiers()
    state = train_step.create_train_state(model, TrainConfig(), SPE)
    state.optimizer.zero_grad()
    _set_grads(model, _grad_seq(model, 1.0)[0])
    p = model.get_parameter("transformer.head.weight")
    p.grad = p.grad.clone()
    with pytest.raises(RuntimeError, match="transformer.head.weight was replaced"):
        train_step.apply_gradients(state)
    assert state.optimizer.count == 0


def test_the_update_needs_no_host_sync(monkeypatch):
    model = FlatTiers()
    state = train_step.create_train_state(model, TrainConfig(), SPE)
    state.optimizer.zero_grad()
    _set_grads(model, _grad_seq(model, 1.0)[0])

    def refuse(*args, **kw):
        raise AssertionError("a host sync in the flat update")

    for name in ("item", "tolist", "__float__", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    train_step.all_reduce_gradients(state)
    train_step.apply_gradients(state)
    monkeypatch.undo()
    assert state.optimizer.count == 1


def test_model_pt_is_the_per_leaf_size_and_a_partial_dict_is_not_the_buffer(tmp_path):
    flat, leaf = _tiny_flagship(), _tiny_flagship()
    train_step.create_train_state(flat, TrainConfig())
    train_step.create_train_state(leaf, TrainConfig(flat_opt=False))
    sizes = {}
    for name, m in (("flat", flat), ("leaf", leaf)):
        save_checkpoint(str(tmp_path / name), m.state_dict(), None)
        sizes[name] = os.path.getsize(tmp_path / name / "model.pt")
    assert abs(sizes["flat"] - sizes["leaf"]) <= 0.01 * sizes["leaf"], sizes
    sd, _, _ = load_checkpoint(str(tmp_path / "flat"))
    for k, v in leaf.state_dict().items():
        assert torch.equal(sd[k], v), k
    part = {k: v for k, v in flat.state_dict().items() if k.startswith("class_embed.")}
    assert part
    save_checkpoint(str(tmp_path / "part"), part, None)
    nbytes = sum(v.numel() * v.element_size() for v in part.values())
    assert os.path.getsize(tmp_path / "part" / "model.pt") < nbytes + 64 * 1024
    sd, _, _ = load_checkpoint(str(tmp_path / "part"))
    assert sorted(sd) == sorted(part) and all(torch.equal(sd[k], part[k]) for k in part)


def test_the_flagship_parameters_are_contiguous():
    """Every parameter of the full-width flagship is contiguous, so that a
    view of the flat buffer has the strides autograd gives its gradient;
    built on the meta device (shapes only)."""
    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.models.referformer import ReferFormer

    with torch.device("meta"):
        model = ReferFormer(flagship_config())
    named = list(model.named_parameters())
    assert sum(p.numel() for _, p in named) == 183_506_503
    assert all(p.is_contiguous() and p.dtype == torch.float32 for _, p in named)
    lay = flat_adamw.make_layout(model, TrainConfig())
    assert lay.frozen_len == 0 and sum(lay.sizes) == 183_506_503
    assert 0 <= lay.live_total - 183_506_503 < flat_adamw.ALIGN * len(named)
    assert [t for _, _, t in lay.tier_slices] == [1e-4, 2e-5, 1e-5, 1e-4]


def test_update_scalars_are_the_jax_f32_values():
    lay = flat_adamw.make_layout(FlatTiers(), TrainConfig(lr_drop=(1, 3)), SPE)
    s = flat_adamw.update_scalars(lay, count=4, sched=2)
    lr_t = np.float32(jax_ts.multistep_schedule(1.0, JaxTrainConfig(lr_drop=(1, 3)), SPE)(2))
    c = jnp.float32(5)
    assert s.bc1 == float(1.0 - 0.9 ** c) and s.bc2 == float(1.0 - 0.999 ** c)
    for (_, _, rel), lr, decay in zip(lay.tier_slices, s.lrs, s.decays):
        step_lr = jnp.float32(lr_t) * rel
        assert lr == float(step_lr) and decay == float(1.0 - step_lr * 5e-4)
    assert dataclasses.is_dataclass(lay) and s.his[-1] == lay.live_total
