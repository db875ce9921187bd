"""Checkpoint ingestion of the port (counterpart of
``tce_rvos_tpu/utils/checkpoint.py::load_torch_file``,
``convert_state_dict`` and ``drop_class_heads``).

The port's parameters already carry the reference torch layout and names
(``utils/convert.py``), so a reference ``.pth`` needs no conversion: it is
laid over the state_dict of a freshly built model with the reference's
``strict=False`` semantics (missing and unexpected keys are reported, a
shape mismatch raises). Saving and restoring training state is in
``utils/native_ckpt.py``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch


def load_torch_file(path: str, with_meta: bool = False):
    """A reference checkpoint as a ``{key: tensor}`` dict on the CPU: the
    ``model`` entry of a training checkpoint, or its ``state_dict`` entry,
    or the file itself. ``with_meta`` also returns ``{"epoch": n}`` when the
    file records the finished epoch. An ``http(s)://`` path goes through
    the ``torch.hub`` cache."""
    if path.startswith(("http://", "https://")):
        ckpt = torch.hub.load_state_dict_from_url(path, map_location="cpu", check_hash=False)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    meta = ({"epoch": int(ckpt["epoch"])}
            if isinstance(ckpt, dict) and "epoch" in ckpt else {})
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v) for k, v in ckpt.items()}
    return (sd, meta) if with_meta else sd


def convert_state_dict(
    state_dict: Mapping[str, torch.Tensor],
    reference: Mapping[str, torch.Tensor],
    strict: bool = False,
    verbose: bool = True,
) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Lay ``state_dict`` over ``reference`` (a fresh model's state_dict).
    Returns (the new state_dict, the reference keys left at init, the
    checkpoint keys unused). Each loaded tensor takes the reference
    tensor's dtype; a shape that differs raises ``ValueError``, and so do
    missing or unexpected keys under ``strict``."""
    out: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    for key, init in reference.items():
        if key not in state_dict:
            missing.append(key)
            out[key] = init
            continue
        value = state_dict[key]
        if tuple(value.shape) != tuple(init.shape):
            raise ValueError(f"shape mismatch {key}: checkpoint {tuple(value.shape)} "
                             f"vs model {tuple(init.shape)}")
        out[key] = value.detach().to(dtype=init.dtype, device="cpu").clone()
    unexpected = [k for k in state_dict if k not in reference]
    if strict and (missing or unexpected):
        raise ValueError(f"missing={missing}, unexpected={unexpected}")
    if verbose:
        print(f"checkpoint: loaded {len(reference) - len(missing)} tensors, "
              f"{len(missing)} model tensors left at init, "
              f"{len(unexpected)} checkpoint keys unused")
    return out, missing, unexpected


def drop_class_heads(state_dict: Mapping[str, torch.Tensor], num_layers: int = 4
                     ) -> Dict[str, torch.Tensor]:
    """A copy without the class heads of the first ``num_layers`` decoder
    layers, which a fine-tune with another class count re-initialises
    (the reference's tools/load_pretrained_weights.py:3-11)."""
    out = dict(state_dict)
    for layer in range(num_layers):
        out.pop(f"class_embed.{layer}.weight", None)
        out.pop(f"class_embed.{layer}.bias", None)
    return out
