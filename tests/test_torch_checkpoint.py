"""The port's checkpoints and resume (``utils/native_ckpt.py``,
``utils/checkpoint.py::drop_class_heads``,
``parallel/train_step.py::seed_schedule_step``,
``train.py::restore_train_state``), on the CPU.

* a save/load round trip of weights, optimizer state and meta, and the
  manager's retention and latest step;
* a state_dict exported by the JAX package (``export_state_dict``) of the
  tiny flagship model, saved as the reference's ``{"model", "epoch"}``,
  loads with no missing and no unexpected keys, bitwise equal to
  ``state_dict_from_jax``, with its epoch and no optimizer state;
* ``seed_schedule_step`` against the JAX one, each side with its optimizer
  of the same ``flat_opt`` (the optax chain against ``torch.optim.AdamW``,
  the flat AdamW against the port's ``FlatAdamW``): after the fast-forward
  the same per-tier LRs at each step, across a MultiStep drop and on the
  Cyclic triangle, the same parameters (rtol 0, atol 1e-7 on parameters of
  about 0.1: a tenth of the smallest tier's step), and the Adam step
  counters at 0 on both sides;
* resumes against an uninterrupted run, with either optimizer: with
  optimizer state, bitwise the same parameters and the same LRs; from a
  weights-only ``.pth``, the same LR sequence with a fresh AdamW.
"""

import json

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
from tce_rvos_tpu.parallel.flat_adamw import FlatAdamWState, make_flat_adamw
from tce_rvos_tpu.utils.checkpoint import export_state_dict
from tce_rvos_tpu_torch.config import ModelConfig, TrainConfig
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.parallel import train_step
from tce_rvos_tpu_torch.parallel.flat_adamw import FlatAdamW
from tce_rvos_tpu_torch.train import restore_train_state
from tce_rvos_tpu_torch.utils.checkpoint import drop_class_heads
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from tce_rvos_tpu_torch.utils.native_ckpt import (
    CheckpointManager,
    load_any_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import FLAGSHIP_TINY, tiny_model

PARAM_TOL = 1e-7


class Tiers(nn.Module):
    """One parameter pair in each LR tier: backbone.0, text_encoder,
    transformer.reference_points (linear_proj) and transformer.head (base)."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.backbone = nn.ModuleList([nn.Linear(3, 4)])
        self.text_encoder = nn.Linear(4, 2)
        self.transformer = nn.Module()
        self.transformer.reference_points = nn.Linear(4, 2)
        self.transformer.head = nn.Linear(4, 3)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))


def _grads(model, n_steps: int, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    return [{name: torch.randn(p.shape, generator=gen) for name, p in model.named_parameters()}
            for _ in range(n_steps)]


def _step(state, grads):
    """One update of the port from given gradients (into the flat AdamW's
    gradient buffer, or as new ``.grad`` tensors after ``--no-flat_opt``'s
    ``zero_grad``); returns the tiers' LRs of the update, as float32."""
    opt = state.optimizer
    opt.zero_grad()
    for name, p in state.model.named_parameters():
        if p.grad is None:
            p.grad = grads[name].clone()
        else:
            p.grad.copy_(grads[name])
    lrs = {t: np.float32(lr) for t, lr in opt.lrs().items()}
    train_step.apply_gradients(state)
    return lrs


def _adam_step(state) -> int:
    """The port's Adam step counter (bias correction): 0 before any update."""
    return max(state.optimizer.adam_counts(), default=0)


def _trained_state():
    """Tiers and an AdamW that has taken one step (its state is not empty)."""
    model = Tiers()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    loss = sum((p ** 2).sum() for p in model.parameters())
    loss.backward()
    opt.step()
    return model, opt


def test_save_load_round_trip(tmp_path):
    model, opt = _trained_state()
    path = str(tmp_path / "ck")
    save_checkpoint(path, model.state_dict(), opt.state_dict(), epoch=3, step=17,
                    extra={"note": "x"})
    sd, opt_sd, meta = load_checkpoint(path)
    assert meta == {"epoch": 3, "step": 17, "note": "x"}
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    fresh = Tiers(seed=5)
    fresh_opt = torch.optim.AdamW(fresh.parameters(), lr=1e-3)
    fresh.load_state_dict(sd)
    fresh_opt.load_state_dict(opt_sd)
    for (_, a), (_, b) in zip(opt.state.items(), fresh_opt.state.items()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[k], b[k]), k
    # a save without optimizer state removes a stale optimizer.pt
    save_checkpoint(path, model.state_dict(), None, epoch=4, step=18)
    _, opt_sd, meta = load_checkpoint(path)
    assert opt_sd is None and meta["epoch"] == 4
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["meta.json", "model.pt"]


def test_manager_retention_and_latest(tmp_path):
    model = Tiers()
    mgr = CheckpointManager(str(tmp_path / "mgr"), max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 2, 3):
        scaled = {k: v * step for k, v in model.state_dict().items()}
        mgr.save(step, scaled, meta={"epoch": step - 1, "step": step})
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    sd, opt_sd, meta = mgr.restore()
    assert opt_sd is None and meta == {"epoch": 2, "step": 3}
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v * 3), k
    assert mgr.restore(step=2)[2]["epoch"] == 1
    (tmp_path / "mgr" / "9").mkdir()  # a save cut before its meta.json: not a step
    assert mgr.latest_step() == 3
    mgr.close()


def test_drop_class_heads():
    sd = {"class_embed.0.weight": torch.zeros(2), "class_embed.3.bias": torch.zeros(1),
          "class_embed.4.bias": torch.zeros(1), "other": torch.ones(1)}
    out = drop_class_heads(sd, num_layers=4)
    assert sorted(out) == ["class_embed.4.bias", "other"]
    assert "class_embed.0.weight" in sd  # the input is not changed


def test_jax_export_loads_strictly(tmp_path):
    """The reference's checkpoint format written from the JAX package's
    weights: every key of the port's model, nothing else, bitwise."""
    _, _, variables, flat, _ = tiny_model("flagship")
    exported = export_state_dict(variables)
    pth = tmp_path / "checkpoint0003.pth"
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in exported.items()},
                "epoch": 3}, pth)
    reference = ReferFormer(ModelConfig(**FLAGSHIP_TINY)).state_dict()
    sd, opt_sd, meta = load_any_checkpoint(str(pth), reference, strict=True)
    assert opt_sd is None and meta == {"epoch": 3}
    want = state_dict_from_jax(flat)
    assert sorted(sd) == sorted(want) == sorted(reference)
    for k, v in want.items():
        assert sd[k].dtype == reference[k].dtype
        assert torch.equal(sd[k], v.to(sd[k].dtype)), k


def test_jax_checkpoint_directory_is_refused(tmp_path):
    (tmp_path / "jaxck").mkdir()
    (tmp_path / "jaxck" / "variables.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="variables.msgpack"):
        load_any_checkpoint(str(tmp_path / "jaxck"), Tiers().state_dict())


def _jax_tree(model):
    """The Tiers parameters as a JAX params tree whose paths fall in the
    same tiers (backbone/0/weight, text_encoder/..., transformer/...),
    copied: a JAX array made from a numpy view of a CPU tensor may share
    its memory, and the port updates its parameters in place."""
    return traverse_util.unflatten_dict(
        {tuple(n.split(".")): jnp.array(p.detach().numpy(), copy=True) for n, p in
         model.named_parameters()})


def _jax_lr(cfg: JaxTrainConfig, tier: str, spe: int, step: int) -> float:
    if cfg.cyclic_lr:
        return float(jax_ts.cyclic_schedule(*cfg.cyclic_lr_boundary, spe // 2)(step))
    base = {"base": cfg.lr, "backbone": cfg.lr_backbone, "text_encoder": cfg.lr_text_encoder,
            "linear_proj": cfg.lr * cfg.lr_linear_proj_mult}[tier]
    return float(jax_ts.multistep_schedule(base, cfg, spe)(step))


def _adam_counts(opt_state):
    nodes = jax.tree.leaves(opt_state, is_leaf=lambda n: isinstance(
        n, (optax.ScaleByAdamState, FlatAdamWState)))
    return [int(n.count) for n in nodes if isinstance(n, (optax.ScaleByAdamState,
                                                           FlatAdamWState))]


@pytest.mark.parametrize("flat", [False, True], ids=["chain", "flat"])
@pytest.mark.parametrize("schedule", ["multistep", "cyclic"])
def test_seed_schedule_step_matches_jax(flat, schedule):
    kw = dict(lr_drop=(1, 3)) if schedule == "multistep" else dict(cyclic_lr=True)
    spe, start, n_steps = 2, 1, 6  # steps 1..6 cross the drops at steps 2 and 6
    jcfg = JaxTrainConfig(flat_opt=flat, **kw)
    model = Tiers()
    params = _jax_tree(model)
    tx = (make_flat_adamw(params, jcfg, spe) if flat
          else jax_ts.make_optimizer(params, jcfg, spe))
    jstate = jax_ts.seed_schedule_step(
        jax_ts.TrainState(params=params, frozen={}, opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32)), start)
    assert int(jstate.step) == start
    assert _adam_counts(jstate.opt_state) and set(_adam_counts(jstate.opt_state)) == {0}

    state = train_step.create_train_state(model, TrainConfig(flat_opt=flat, **kw), spe)
    assert isinstance(state.optimizer, FlatAdamW) == flat
    state = train_step.seed_schedule_step(state, start)
    assert state.step == start and _adam_step(state) == 0  # AdamW's step absent: 0
    if flat:
        assert state.optimizer.sched == start

    jparams, opt_state = jstate.params, jstate.opt_state
    for k, grads in enumerate(_grads(model, n_steps)):
        lrs = _step(state, grads)
        for tier, lr in lrs.items():
            assert lr == pytest.approx(_jax_lr(jcfg, tier, spe, start + k), rel=1e-6), (k, tier)
        jgrads = traverse_util.unflatten_dict(
            {tuple(n.split(".")): jnp.array(g.numpy(), copy=True) for n, g in grads.items()})
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat_j = traverse_util.flatten_dict(jparams, sep=".")
        for name, p in state.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(flat_j[name]), rtol=0,
                                       atol=PARAM_TOL, err_msg=f"step {start + k} {name}")
    assert state.step == start + n_steps


def test_resume_reproduces_an_uninterrupted_run(tmp_path):
    check_resume(tmp_path, flat_opt=True)


def test_resume_with_no_flat_opt_reproduces_an_uninterrupted_run(tmp_path):
    check_resume(tmp_path, flat_opt=False)


def check_resume(tmp_path, flat_opt: bool):
    cfg, spe = TrainConfig(lr_drop=(2, 3), flat_opt=flat_opt), 2
    grads = _grads(Tiers(), 8)
    full = train_step.create_train_state(Tiers(), cfg, spe)
    lrs_full = []
    for k in range(8):
        lrs_full.append(_step(full, grads[k]))
        if k == 3:  # the end of epoch 1: checkpoint as train.main does
            save_checkpoint(str(tmp_path / "checkpoint"), full.model.state_dict(),
                            full.optimizer.state_dict(), epoch=1, step=full.step)
            torch.save({"model": full.model.state_dict(), "epoch": 1}, tmp_path / "ref.pth")
    assert [lr["base"] for lr in lrs_full] == pytest.approx([1e-4] * 4 + [1e-5] * 2 + [1e-6] * 2,
                                                            rel=1e-6)

    # with optimizer state: bitwise the uninterrupted run
    resumed, start_epoch = restore_train_state(
        train_step.create_train_state(Tiers(seed=9), cfg, spe), str(tmp_path / "checkpoint"),
        None, spe)
    assert start_epoch == 2 and resumed.step == 4
    lrs = [_step(resumed, grads[k]) for k in range(4, 8)]
    assert lrs == lrs_full[4:]
    for name, p in resumed.model.named_parameters():
        assert torch.equal(p, full.model.get_parameter(name)), name

    # weights only (the reference's .pth): the schedules fast-forwarded, AdamW fresh
    fresh, start_epoch = restore_train_state(
        train_step.create_train_state(Tiers(seed=9), cfg, spe), str(tmp_path / "ref.pth"),
        None, spe)
    assert start_epoch == 2 and fresh.step == 4 and _adam_step(fresh) == 0
    assert [_step(fresh, grads[k]) for k in range(4, 8)] == lrs_full[4:]

    # the manager: restore() takes the latest step, whatever the path says
    mgr = CheckpointManager(str(tmp_path / "orbax"))
    mgr.save(4, full.model.state_dict(), None, meta={"epoch": 1, "step": 4})
    via_mgr, start_epoch = restore_train_state(
        train_step.create_train_state(Tiers(seed=9), cfg, spe), "ignored", mgr, spe)
    assert start_epoch == 2 and via_mgr.step == 4
    with open(tmp_path / "orbax" / "4" / "meta.json") as fh:
        assert json.load(fh) == {"epoch": 1, "step": 4}
