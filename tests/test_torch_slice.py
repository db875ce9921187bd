"""The PyTorch port's serving slice against the JAX package, end to end, on
the CPU: the tiny flagship-shaped model (FTF, IQT, box refinement, binary)
on shared seeded weights carried by ``state_dict_from_jax``, and the plain
ReferFormer without FTF, IQT and box refinement for the direct forward.

The JAX model runs with ``msda_impl="xla"``, its CPU default; the port runs
its plain MSDA on the CPU. Tolerance 2e-3 (rtol and atol): the model-level
bar of the JAX package's parity against the reference torch model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tce_rvos_tpu.infer import InferenceEngine as JaxInferenceEngine
from tce_rvos_tpu.infer import masks_to_original as jax_masks_to_original
from tce_rvos_tpu.infer import select_query as jax_select_query
from tce_rvos_tpu.utils.checkpoint import export_state_dict
from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.infer import InferenceEngine, masks_to_original, select_query
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import FLAGSHIP_TINY, VARIANTS, assert_close, tiny_model

TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def shared():
    return tiny_model("flagship")


def _port(flat, variant="flagship") -> ReferFormer:
    port = ReferFormer(ModelConfig(**VARIANTS[variant]))
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    return port.eval()


def test_state_dict_from_jax_equals_export_and_loads_strict(shared):
    _, _, variables, flat, _ = shared
    sd = state_dict_from_jax(flat)
    ref = export_state_dict(variables)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    _port(flat)  # strict=True


@pytest.mark.parametrize("variant", ["flagship", "plain"])  # flagship_3d: test_torch_slice3d.py
def test_forward_matches_jax(variant):
    _, model, variables, flat, inputs = tiny_model(variant)
    want = jax.jit(model.apply)(variables, **{k: jnp.asarray(v) for k, v in inputs.items()})
    port = _port(flat, variant)
    with torch.inference_mode():
        got = port(
            torch.from_numpy(inputs["video"]), torch.from_numpy(inputs["video_mask"]),
            torch.from_numpy(inputs["text_ids"]).long(),
            torch.from_numpy(inputs["text_attn_mask"]).long(),
            torch.from_numpy(inputs["sizes"]).long())
    for k in ("pred_logits", "pred_boxes", "pred_masks", "reference_points",
              "inter_samples", "memory"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert_close(got[k], want[k], name=k, **TOL)


def test_run_video_batch_matches_jax(shared):
    """E = 3 captions (padded to 4) over a 5-frame video in 3-frame windows;
    frames at 48x72 are resized to 64x96 (cv2 in the JAX engine,
    F.interpolate in the port)."""
    jcfg, _, variables, flat, _ = shared
    rng = np.random.RandomState(1)
    frames = [rng.rand(48, 72, 3).astype(np.float32) for _ in range(5)]
    caps = ["the red ball", "a running dog on the grass next to the small tree",
            "the red ball again"]
    kw = dict(size=64, max_size=96, window=3)
    want = JaxInferenceEngine(jcfg, variables, **kw).run_video_batch(frames, caps, exp_batch=4)
    engine = InferenceEngine(ModelConfig(**FLAGSHIP_TINY), state_dict_from_jax(flat),
                             device="cpu", **kw)
    got = engine.run_video_batch(frames, caps, exp_batch=4)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["model_size"] == w["model_size"]
        for k in ("pred_logits", "pred_boxes", "pred_masks", "reference_points",
                  "inter_samples"):
            assert g[k].shape == w[k].shape, k
            assert_close(g[k], w[k], name=k, **TOL)


def test_select_query_and_masks_to_original_match_jax():
    """Post-processing of one expression's outputs: the query chosen for
    the whole video, and stride-4 logits (cropped to the unpadded size)
    upsampled to the original frame size as sigmoid scores."""
    rng = np.random.RandomState(2)
    logits = rng.randn(6, 5, 1).astype(np.float32)
    assert select_query(logits) == jax_select_query(logits)
    mask_logits = (rng.randn(6, 16, 24) * 4).astype(np.float32)
    model_size, orig_size = (60, 90), (50, 75)
    want = jax_masks_to_original(mask_logits, model_size, orig_size)
    got = masks_to_original(mask_logits, model_size, orig_size, device="cpu")
    assert got.shape == want.shape == (6, 50, 75)
    assert_close(got, want, rtol=1e-5, atol=1e-5)
