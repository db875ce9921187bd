"""Training without the mask losses, against the JAX package on the CPU:
one step of ``make_train_step`` on the tiny model of configuration (A)
with ``masks=False`` (the command line without ``--masks``: no mask
focal/dice losses, no mask costs in the matcher) against
``jax.value_and_grad`` of the JAX model's loss and the optax chain, held
as ``torch_parity_helpers.check_two_train_steps`` says. The mask head's
and the pixel decoder's gradients are zero on both sides, and AdamW's
weight decay still moves those parameters, as optax's does."""

from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import (
    OPTIONS_STEP_SEED,
    check_two_train_steps,
    model_inputs,
    train_targets,
)


def test_a_train_step_without_masks_matches_jax():
    check_two_train_steps("options_a_nomasks", n_steps=1,
                          batch=dict(model_inputs(seed=OPTIONS_STEP_SEED),
                                     targets=train_targets(num_classes=65)))
