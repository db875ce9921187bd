"""The PyTorch port's temporal-MSDA slice (``--msda_3d``) against the JAX
package, end to end, on the CPU: the tiny flagship-shaped model with
``msda_3d=True`` (3D MSDA in the encoder's self-attention and the decoder's
cross-attention, 2D in FTF) on shared seeded weights carried by
``state_dict_from_jax``.

The JAX model runs with ``msda_impl="xla"``; the port runs its plain 3D MSDA
on the CPU. Tolerance 2e-3 (rtol and atol): the model-level bar of the JAX
package's parity against the reference torch model. The inputs stack B = 2
clips (and ``run_video_batch`` E = 4 expressions) on the batch axis, which
the 3D op takes as time: the seeded temporal offsets carry taps across clips
and expressions, in both packages alike.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tce_rvos_tpu.infer import InferenceEngine as JaxInferenceEngine
from tce_rvos_tpu.utils.checkpoint import export_state_dict
from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.infer import InferenceEngine
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.models.transformer import MSDeformAttn
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import FLAGSHIP_3D_TINY, assert_close, tiny_model

TOL = dict(rtol=2e-3, atol=2e-3)


def _port(flat) -> ReferFormer:
    port = ReferFormer(ModelConfig(**FLAGSHIP_3D_TINY))
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    return port.eval()


def test_3d_modules_are_where_the_jax_package_puts_them():
    """Encoder self-attention and decoder cross-attention are 3D (3 offset
    coordinates per point), FTF's token attention stays 2D."""
    port = ReferFormer(ModelConfig(**FLAGSHIP_3D_TINY))
    kinds = {name: (mod.is_3d, mod.sampling_offsets.out_features
                          // (mod.n_heads * mod.n_levels * mod.n_points))
             for name, mod in port.named_modules() if isinstance(mod, MSDeformAttn)}
    assert kinds and all(
        v == ((True, 3) if name.endswith(("self_attn", "cross_attn")) else (False, 2))
        for name, v in kinds.items()), kinds
    assert sum(v[0] for v in kinds.values()) == 4  # 2 encoder + 2 decoder layers


def test_state_dict_from_jax_equals_export_and_loads_strict():
    _, _, variables, flat, _ = tiny_model("flagship_3d")
    sd = state_dict_from_jax(flat)
    ref = export_state_dict(variables)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    offsets = sd["transformer.encoder.layers.0.self_attn.sampling_offsets.weight"]
    assert offsets.shape == (8 * 4 * 4 * 3, 256)  # heads x levels x points x (x, y, f)
    _port(flat)  # strict=True


def test_forward_matches_jax():
    """B = 2 clips of 3 frames: the 3D op's frame axis is the batch of 6."""
    _, model, variables, flat, inputs = tiny_model("flagship_3d")
    want = jax.jit(model.apply)(variables, **{k: jnp.asarray(v) for k, v in inputs.items()})
    port = _port(flat)
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


def test_run_video_batch_matches_jax():
    """E = 3 captions (padded to 4) over a 5-frame video in 3-frame windows,
    as ``tests/test_torch_slice.py`` runs the 2D flagship."""
    jcfg, _, variables, flat, _ = tiny_model("flagship_3d")
    rng = np.random.RandomState(1)
    frames = [rng.rand(48, 72, 3).astype(np.float32) for _ in range(5)]
    caps = ["the red ball", "a running dog on the grass next to the small tree",
            "the red ball again"]
    kw = dict(size=64, max_size=96, window=3)
    want = JaxInferenceEngine(jcfg, variables, **kw).run_video_batch(frames, caps, exp_batch=4)
    engine = InferenceEngine(ModelConfig(**FLAGSHIP_3D_TINY), state_dict_from_jax(flat),
                             device="cpu", **kw)
    got = engine.run_video_batch(frames, caps, exp_batch=4)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["model_size"] == w["model_size"]
        for k in ("pred_logits", "pred_boxes", "pred_masks", "reference_points",
                  "inter_samples"):
            assert g[k].shape == w[k].shape, k
            assert_close(g[k], w[k], name=k, **TOL)
