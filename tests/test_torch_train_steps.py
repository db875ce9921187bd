"""The PyTorch port's training slice as a whole, against the JAX package on
the CPU: two steps of ``make_train_step`` on the tiny flagship-shaped model
(FTF, IQT, box refinement, binary, f32, dropout off) against
``jax.value_and_grad`` of the JAX model's loss and the optax chain of
``make_optimizer``, from the same weights and batch. The JAX package's
``make_train_step`` always draws dropout, so its loss is built from
``model.apply(..., deterministic=True)`` and ``criterion``. Held as
``torch_parity_helpers.check_two_train_steps`` says; this file runs apart
from ``tests/test_torch_train.py`` so that each stays under 90 s alone on
one worker, as ``tests/test_torch_train3d.py`` does for ``--msda_3d``."""

from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import check_two_train_steps


def test_two_train_steps_match_jax():
    check_two_train_steps("flagship")
