"""The model options in training, against the JAX package on the CPU: two
steps of ``make_train_step`` on the tiny model of configuration (A)
(``torch_parity_helpers.OPTIONS_A``: ``--f_token -1``, IQT, box
refinement, ytvos's 65 classes, the visibility heads and loss, the
contrastive output; f32, dropout off) against ``jax.value_and_grad`` of
the JAX model's loss and the optax chain of ``make_optimizer``, from the
same weights and batch, each clip's object of a random class. Held as
``torch_parity_helpers.check_two_train_steps`` says. The batch is
``model_inputs(seed=OPTIONS_STEP_SEED)`` (4), not the default clips: on
those, three ReLU inputs lie within f32 rounding of zero and take another
sign in the port's f32 forward than in float64 (one in encoder layer 0's
FFN, where JAX's f32 sign is float64's), so the port's f32 gradients land
up to 2.8e-3 of a backbone gradient's norm from JAX's; on seed 4's none
does (``tests/test_torch_slice_options.py`` holds that premise). The step without
the mask losses (``--masks`` not given) is in
``tests/test_torch_train_nomasks.py``, so that each file stays under
90 s alone on one worker."""

from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import (
    OPTIONS_STEP_SEED,
    check_two_train_steps,
    model_inputs,
    train_targets,
)


def test_two_train_steps_of_the_options_match_jax():
    check_two_train_steps("options_a",
                          batch=dict(model_inputs(seed=OPTIONS_STEP_SEED),
                                     targets=train_targets(num_classes=65)))
