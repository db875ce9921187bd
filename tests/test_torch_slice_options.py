"""The model options as a whole, against the JAX package on the CPU: the
tiny model in two combined configurations (``torch_parity_helpers``):

* (A) ``--f_token -1`` (LastLayerAsToken), IQT, box refinement, ytvos's
  65 classes, ``--vis_loss`` and ``--contrastive``;
* (B) ``--vlblock`` (no V-L blocks), ``--no_rel_coord``, no box
  refinement, davis's 78 classes, FTF with 2 tokens.

The port's forward (with the auxiliary outputs) against the JAX model's,
every output at SLICE_TOL (2e-3, the model-level bar of the JAX package's
parity with the reference); the JAX package's ``export_state_dict`` loads
strictly into the port model; a reference checkpoint's unused
``inter_frame_atten.norm1.*`` is reported, not loaded; the premise of
(A)'s train steps' clips (``OPTIONS_STEP_SEED``): ReLU inputs that take
another sign in f32 than in float64 on the default clips, none on those.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tce_rvos_tpu.utils.checkpoint import export_state_dict
from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.parallel.train_step import batch_to_device
from tce_rvos_tpu_torch.utils.checkpoint import convert_state_dict
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import (
    OPTIONS_STEP_SEED,
    SLICE_TOL,
    VARIANTS,
    assert_close,
    model_inputs,
    tiny_model,
)

OPTION_VARIANTS = ("options_a", "options_b")


def _port(variant):
    _, _, _, flat, _ = tiny_model(variant)
    port = ReferFormer(ModelConfig(**VARIANTS[variant]))
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    return port.eval()


@pytest.mark.parametrize("variant", OPTION_VARIANTS)
def test_forward_matches_jax(variant):
    jcfg, model, variables, _, inputs = tiny_model(variant)
    want = jax.jit(model.apply)(variables, **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.inference_mode():
        got = _port(variant)(
            torch.from_numpy(inputs["video"]), torch.from_numpy(inputs["video_mask"]),
            torch.from_numpy(inputs["text_ids"]).long(),
            torch.from_numpy(inputs["text_attn_mask"]).long(),
            torch.from_numpy(inputs["sizes"]).long(), aux_outputs=True)
    keys = ["pred_logits", "pred_boxes", "pred_masks", "reference_points", "inter_samples",
            "memory"]
    keys += [k for k in ("pred_visible", "contrastive") if k in want]
    assert sorted(k for k in got if k != "aux_outputs") == sorted(
        k for k in want if k != "aux_outputs")
    assert got["pred_logits"].shape[-1] == jcfg.num_classes > 1
    if variant == "options_a":
        assert "pred_visible" in want and want["contrastive"].shape == (2, 3)
    for k in keys:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert_close(got[k], want[k], rtol=SLICE_TOL, atol=SLICE_TOL, name=k)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == jcfg.dec_layers - 1
    for i, (g, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        assert sorted(g) == sorted(w)
        for k in w:
            assert_close(g[k], w[k], rtol=SLICE_TOL, atol=SLICE_TOL, name=f"aux {i} {k}")


@pytest.mark.parametrize("variant", OPTION_VARIANTS)
def test_jax_export_loads_strictly(variant):
    _, _, variables, flat, _ = tiny_model(variant)
    exported = {k: torch.from_numpy(np.array(v)) for k, v in export_state_dict(variables).items()}
    port = ReferFormer(ModelConfig(**VARIANTS[variant]))
    port.load_state_dict(exported, strict=True)
    want = state_dict_from_jax(flat)
    assert sorted(exported) == sorted(want)
    for k, v in want.items():
        assert torch.equal(exported[k], v), k


def test_reference_norm1_of_last_layer_as_token_is_reported_unused(capsys):
    """The reference's LastLayerAsToken defines a ``norm1`` it never uses,
    so its checkpoints carry ``inter_frame_atten.norm1.*``: the overlay
    reports those keys as unused and loads everything else."""
    _, _, variables, _, _ = tiny_model("options_a")
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_state_dict(variables).items()}
    extra = {f"transformer.encoder.layers.{i}.inter_frame_atten.norm1.{leaf}": torch.ones(32)
             for i in range(2) for leaf in ("weight", "bias")}
    reference = ReferFormer(ModelConfig(**VARIANTS["options_a"])).state_dict()
    out, missing, unexpected = convert_state_dict({**sd, **extra}, reference)
    assert missing == [] and sorted(unexpected) == sorted(extra)
    assert f"loaded {len(reference)} tensors, 0 model tensors left at init, 4 checkpoint " \
           "keys unused" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unexpected=.*inter_frame_atten.norm1"):
        convert_state_dict({**sd, **extra}, reference, strict=True, verbose=False)


def _relu_sign_flips(variant, seed, monkeypatch) -> int:
    """How many ReLU inputs of the port's forward on ``model_inputs(seed)``
    are positive in float64 and not in f32, or the other way round."""
    relu = F.relu
    signs = {}
    for dtype in (torch.float64, torch.float32):
        seen = signs[dtype] = []
        monkeypatch.setattr(F, "relu", lambda x, inplace=False, seen=seen: (
            seen.append(x.detach() > 0), relu(x))[1])
        batch = batch_to_device(model_inputs(seed), torch.device("cpu"))
        with torch.no_grad():
            _port("options_a").to(dtype)(
                batch["video"].to(dtype), batch["video_mask"], batch["text_ids"],
                batch["text_attn_mask"], batch["sizes"], aux_outputs=True)
    monkeypatch.setattr(F, "relu", relu)
    assert len(signs[torch.float64]) == len(signs[torch.float32]) > 0
    return sum(int((a != b).sum()) for a, b in zip(signs[torch.float64], signs[torch.float32]))


def test_the_step_clips_have_no_relu_on_the_edge_in_f32(monkeypatch):
    assert _relu_sign_flips("options_a", 0, monkeypatch) > 0
    assert _relu_sign_flips("options_a", OPTIONS_STEP_SEED, monkeypatch) == 0
