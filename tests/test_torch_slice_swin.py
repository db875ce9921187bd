"""The port's model with a Video-Swin backbone against the JAX package, end
to end, on the CPU: the tiny flagship-shaped model (FTF, IQT, box
refinement, binary, a narrow transformer and text encoder) with a
full-width Video-Swin-T backbone, on shared seeded weights carried by
``state_dict_from_jax``:

* the forward (2 clips of 3 frames at 64x96: the temporal window shrinks
  to 3);
* ``run_video_batch``'s whole-video path: 10 frames rounded up to a
  16-frame window by ``t_bucket`` 8, so the backbone runs 8-frame windows
  with a temporal shift of 4 and the 3D shift mask;
* the premise of the two train steps' clips: the port's f32 gradients lie
  more than 2e-3 from its float64 ones on the default clips (seed 0), and
  within 1e-4 on ``SWIN_STEP_SEED``'s.

Two train steps are in ``tests/test_torch_train_swin.py``, the Swin-T and
X3D-S forwards in ``tests/test_torch_slice_backbones.py`` (each file stays
under 90 s alone on one worker). Tolerance: the model-level ``SLICE_TOL``
(rtol and atol)."""

import numpy as np
import torch

from tce_rvos_tpu_torch.config import ModelConfig, TrainConfig
from tce_rvos_tpu_torch.infer import OUTPUT_KEYS
from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.parallel.train_step import batch_to_device, forward_losses
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import (
    SLICE_TOL,
    SWIN_STEP_SEED,
    VARIANTS,
    assert_close,
    check_forward_matches_jax,
    engine_pair,
    model_inputs,
    tiny_model,
    train_targets,
)

VARIANT = "flagship_video_swin"


def test_forward_matches_jax():
    check_forward_matches_jax(VARIANT)


def test_whole_video_run_video_batch_matches_jax():
    jax_engine, engine = engine_pair(VARIANT, size=64, max_size=96, t_bucket=8)
    assert engine.window_length(10, whole_video=True) == 16
    rng = np.random.RandomState(6)
    frames = [rng.rand(48, 72, 3).astype(np.float32) for _ in range(10)]
    caps = ["the red ball", "a running dog"]
    want = jax_engine.run_video_batch(frames, caps, whole_video=True)
    got = engine.run_video_batch(frames, caps, whole_video=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["model_size"] == w["model_size"]
        for k in OUTPUT_KEYS:
            assert g[k].shape == w[k].shape and g[k].shape[0] == 10, k
            assert_close(g[k], w[k], rtol=SLICE_TOL, atol=SLICE_TOL, name=k)


def _f32_gap_to_f64(seed: int) -> float:
    """The largest gap, relative to its norm, between a parameter's f32 and
    float64 gradient of the port's loss on ``model_inputs(seed)`` (the
    gradients zero in exact arithmetic left out)."""
    flat = tiny_model(VARIANT)[3]
    cfg = ModelConfig(**VARIANTS[VARIANT])
    crit = criterion_from_configs(cfg, TrainConfig())
    grads = []
    for dtype in (torch.float64, torch.float32):
        port = ReferFormer(cfg)
        port.load_state_dict(state_dict_from_jax(flat), strict=True)
        port.eval().to(dtype)
        batch = batch_to_device(dict(model_inputs(seed), targets=train_targets()),
                                torch.device("cpu"))
        batch["video"] = batch["video"].to(dtype)
        forward_losses(port, batch, crit)[0].backward()
        grads.append({n: p.grad.double() for n, p in port.named_parameters()})
    g64, g32 = grads
    g_max = max(float(g.abs().max()) for g in g64.values())
    return max(float((g32[n] - g).norm() / g.norm()) for n, g in g64.items()
               if float(g.abs().max()) > 1e-6 * g_max)


def test_the_step_clips_are_well_conditioned_in_f32():
    assert _f32_gap_to_f64(0) > SLICE_TOL
    assert _f32_gap_to_f64(SWIN_STEP_SEED) < 1e-4
