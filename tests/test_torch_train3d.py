"""The PyTorch port's temporal-MSDA slice (``--msda_3d``) in training, against
the JAX package on the CPU: two steps of ``make_train_step`` on the tiny
flagship model with ``msda_3d=True`` (f32, dropout off) against
``jax.value_and_grad`` of the JAX model's loss (``msda_impl="xla"``) and the
optax chain of ``make_optimizer``, from the same weights and batch of B = 2
clips, whose temporal taps cross from one clip into the other in both
packages. Held as ``torch_parity_helpers.check_two_train_steps`` says, as the
2D flagship is in ``tests/test_torch_train.py``; this file runs apart from
``tests/test_torch_slice3d.py`` so that each stays well under 90 s on one
worker."""

from torch_parity_helpers import check_two_train_steps


def test_two_train_steps_match_jax_3d():
    check_two_train_steps("flagship_3d")
