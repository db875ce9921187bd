"""The forward of the tiny flagship-shaped model (FTF, IQT, box refinement,
binary, a narrow transformer and text encoder) with a full-width Swin-T
and X3D-S backbone against the JAX package on the CPU, on shared seeded
weights carried by ``state_dict_from_jax``, every output at the
model-level ``SLICE_TOL`` (rtol and atol). Video-Swin-T's slice is in
``tests/test_torch_slice_swin.py``, ResNet-50's in
``tests/test_torch_slice.py``."""

import pytest

from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import check_forward_matches_jax


@pytest.mark.parametrize("variant", ["flagship_swin", "flagship_x3d"])
def test_forward_matches_jax(variant):
    check_forward_matches_jax(variant)
