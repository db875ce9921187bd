"""The PyTorch port's training slice as a whole, against the JAX package on
the CPU: steps of ``make_train_step`` on the tiny flagship-shaped model
(FTF, IQT, box refinement, binary, f32, dropout off) against
``jax.value_and_grad`` of the JAX model's loss and the JAX optimizer, from
the same weights and batch: two steps with ``--no-flat_opt`` (the port's
``torch.optim.AdamW`` against the optax chain of ``make_optimizer``) and
one with the fused flat AdamW on both sides (``make_flat_adamw_fused``).
The JAX package's ``make_train_step`` always draws dropout, so its loss is
built from ``model.apply(..., deterministic=True)`` and ``criterion``. Held
as ``torch_parity_helpers.check_two_train_steps`` says; the two
optimizers' JAX steps share one compiled gradient.

The flat case takes one step on these clips: at the JAX flat AdamW's
parameters after its first step, one ReLU input of the dynamic mask head
lies within f32 rounding of zero and the port's f32 gives it the other
sign, so a few gradients of the controller miss the element limit there
(``test_the_flat_second_point_has_a_relu_input_on_the_f32_edge`` holds
that premise). The flat update's later steps, across LR drops, are held
against the JAX package from given gradients by
``tests/test_torch_flat_adamw.py``. This file runs apart from
``tests/test_torch_train.py`` so that each stays under 90 s alone on one
worker, as ``tests/test_torch_train3d.py`` does for ``--msda_3d``."""

import numpy as np
import pytest
import torch

from tce_rvos_tpu.config import TrainConfig as JaxTrainConfig
from tce_rvos_tpu_torch.config import ModelConfig, TrainConfig
from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.parallel import train_step
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import (
    FLAGSHIP_TINY,
    check_two_train_steps,
    jax_train_runs,
    tiny_model,
    train_targets,
)

N_STEPS = 2


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX steps of both optimizers, by ``flat_opt``."""
    runs = jax_train_runs(tiny_model("flagship"),
                          [JaxTrainConfig(lr_drop=(1,), flat_opt=f) for f in (False, True)],
                          train_targets(), N_STEPS)
    return dict(zip((False, True), runs))


def test_two_train_steps_match_jax(jax_steps):
    check_two_train_steps("flagship", n_steps=N_STEPS, want=jax_steps[False])


def test_train_step_matches_jax_flat_opt(jax_steps):
    check_two_train_steps("flagship", n_steps=1, flat_opt=True, want=jax_steps[True][:1])


def _port_grad(params, dtype, name):
    """The port's gradient of ``name`` at ``params`` (port names, numpy) on
    the tiny model's clips and targets, in ``dtype``, as float64."""
    _, _, _, flat, inputs = tiny_model("flagship")
    cfg = ModelConfig(**FLAGSHIP_TINY)
    port = ReferFormer(cfg)
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    with torch.no_grad():
        for n, p in port.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    port.to(dtype).eval()
    batch = train_step.batch_to_device(dict(inputs, targets=train_targets()),
                                       torch.device("cpu"))
    batch["video"] = batch["video"].to(dtype)
    total, _ = train_step.forward_losses(port, batch, criterion_from_configs(cfg, TrainConfig()))
    total.backward()
    return port.get_parameter(name).grad.double().numpy()


def test_the_flat_second_point_has_a_relu_input_on_the_f32_edge(jax_steps):
    """At the flat AdamW's parameters after the first JAX step the port's
    f32 gradient of ``controller.layers.2.weight`` lies more than the
    element limit (2e-4 of the model's largest |grad|) from the port's own
    float64 gradient there, while JAX's f32 one lies within 1e-5 of it; at
    the optax chain's parameters after its first step both lie within
    1e-5."""
    name = "controller.layers.2.weight"
    for flat_opt, port_far in ((True, True), (False, False)):
        (_, _, _, params), (_, _, grads, _) = jax_steps[flat_opt]
        g_all = max(float(np.abs(g).max()) for g in grads.values())
        f64 = _port_grad(params, torch.float64, name)
        port_gap = float(np.abs(_port_grad(params, torch.float32, name) - f64).max()) / g_all
        jax_gap = float(np.abs(grads[name] - f64).max()) / g_all
        assert jax_gap < 1e-5, (flat_opt, jax_gap)
        assert (port_gap > 2e-4) == port_far, (flat_opt, port_gap)
