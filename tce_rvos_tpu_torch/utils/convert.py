"""Weight bridge: the JAX package's variables -> the port's ``state_dict``.

``state_dict_from_jax(flat)`` takes the flax variables flattened with "/"
keys (``params/transformer/decoder_layers_0/cross_attn/value_proj/kernel``,
``frozen/backbone/bn1/running_var``, X3D's
``batch_stats/backbone/stem_norm/bn/var``) as numpy arrays and returns the
reference torch layout, which is the port's: for every leaf, the key of
``tce_rvos_tpu/utils/checkpoint.py::flax_to_torch_key``, the backbones of
all four families included. Layouts: Dense kernels [in, out] are
transposed, conv kernels go from HWIO to OIHW and from DHWIO to OIDHW (a
depthwise kernel keeps its in-channels per group, 1, in the I axis), and
an attention block's q/k/v projections are packed into ``in_proj_weight``
/ ``in_proj_bias``. The JAX package's ``export_state_dict`` inverts no 3D
conv, so this bridge maps those leaves itself.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping

import numpy as np
import torch

_TEXT_RENAMES = {
    "word_embeddings": "embeddings.word_embeddings",
    "position_embeddings": "embeddings.position_embeddings",
    "token_type_embeddings": "embeddings.token_type_embeddings",
    "embeddings_norm": "embeddings.LayerNorm",
    "pooler_dense": "pooler.dense",
    "attention_self": "attention.self",
    "attention_output_dense": "attention.output.dense",
    "attention_output_norm": "attention.output.LayerNorm",
    "intermediate_dense": "intermediate.dense",
    "output_dense": "output.dense",
    "output_norm": "output.LayerNorm",
}
# parameters that are leaves of their own (no kernel/bias below them)
_BARE = {
    "query_embed": "query_embed.weight",
    "transformer/level_embed": "transformer.level_embed",
    "transformer/memory_bus": "transformer.encoder.memory_bus",
    "transformer/memory_pos": "transformer.encoder.memory_pos",
}
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias",
         "weight": "weight", "running_mean": "running_mean", "running_var": "running_var",
         "mean": "running_mean", "var": "running_var",
         "relative_position_bias_table": "relative_position_bias_table"}
# backbone module names, flax -> torch, one path part each (None: no part;
# X3D's BatchNorm wrapper, whose variables sit on the torch module itself)
_BACKBONE_PARTS = {
    "downsample_conv": "downsample.0", "downsample_bn": "downsample.1",          # ResNet
    "patch_embed_proj": "patch_embed.proj", "patch_embed_norm": "patch_embed.norm",  # Swin
    "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2",
    # X3D: the reference names the stem's spatial conv conv_t, its temporal one conv_xy
    "stem_conv_xy": "blocks.0.conv.conv_t", "stem_conv_t": "blocks.0.conv.conv_xy",
    "stem_norm": "blocks.0.norm", "conv_a": "branch2.conv_a", "conv_b": "branch2.conv_b",
    "conv_c": "branch2.conv_c", "norm_a": "branch2.norm_a", "norm_b": "branch2.norm_b.0",
    "norm_c": "branch2.norm_c", "se": "branch2.norm_b.1", "fc1": "block.0", "fc2": "block.2",
    "bn": None,
}
_BACKBONE_PATTERNS = (
    (r"^layer(\d)_(\d+)$", r"layer\1.\2"),                        # ResNet
    (r"^layers_(\d)_blocks_(\d+)$", r"layers.\1.blocks.\2"),      # (Video-)Swin
    (r"^layers_(\d)_downsample$", r"layers.\1.downsample"),        # Swin
    (r"^downsamples_(\d)$", r"downsamples.\1"),                    # Video-Swin, hoisted
    (r"^out_norm_(\d)$", r"norm\1"),                               # Swin
    (r"^stage(\d)_block(\d+)$", r"blocks.\1.res_blocks.\2"),      # X3D
)


def _layers(parts: List[str]) -> List[str]:
    """MLP ``layers_{i}`` -> ``layers.{i}``."""
    return [re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in parts]


def _module_key(parts: List[str]) -> str:
    top, rest = parts[0], parts[1:]
    if top == "backbone":
        out = ["backbone.0.body"]
        for p in rest:
            for pattern, repl in _BACKBONE_PATTERNS:
                p = re.sub(pattern, repl, p)
            p = _BACKBONE_PARTS.get(p, p)
            if p is not None:
                out.append(p)
        return ".".join(out)
    if top == "text_encoder":
        out = []
        for p in rest:
            p = re.sub(r"^layer_(\d+)$", r"encoder.layer.\1", p)
            out.append(_TEXT_RENAMES.get(p, p))
        return ".".join([top] + out)
    m = re.match(r"^input_proj_(\d+)$", top)
    if m:
        return f"input_proj.{m.group(1)}." + {"conv": "0", "norm": "1"}[rest[0]]
    m = re.match(r"^(class_embed|visible_embed)(?:_(\d+))?$", top)
    if m:
        return f"{m.group(1)}.{m.group(2) or 0}"
    if top == "bbox_embed":
        return ".".join(["bbox_embed.0"] + _layers(rest))
    if top == "controller":
        return ".".join([top] + _layers(rest))
    if top == "transformer":
        m = re.match(r"^bbox_embed_(\d+)$", rest[0])
        if m:
            return ".".join([f"bbox_embed.{m.group(1)}"] + _layers(rest[1:]))
        m = re.match(r"^(encoder|decoder)_layers_(\d+)$", rest[0])
        if m:
            side, i = m.groups()
            sub = rest[1:]
            if sub[0] == "ffn":  # the FFN's layers live on the block itself
                sub = [{"norm": "norm2" if side == "encoder" else "norm3"}.get(sub[1], sub[1])]
            return ".".join([f"transformer.{side}.layers.{i}"] + sub)
        return ".".join([top] + rest)
    if top == "pixel_decoder":
        # the conv wrapper's weight sits on the module itself, its GroupNorm
        # under ``.norm``
        return ".".join([top] + [p for p in rest if p != "conv"])
    return ".".join(parts)


def torch_key(path: str) -> str:
    """Flattened flax path -> reference torch key (q/k/v leaves map to the
    packed ``in_proj_*`` key)."""
    col, _, p = path.partition("/")
    if col not in ("params", "frozen", "batch_stats"):
        raise KeyError(f"unknown variable collection in {path!r}")
    if p in _BARE:
        return _BARE[p]
    *mods, leaf = p.split("/")
    m = re.match(r"^(q|k|v)_proj$", mods[-1])
    if m:
        return f"{_module_key(mods[:-1])}.in_proj_{_LEAF[leaf]}"
    if leaf not in _LEAF:
        raise KeyError(f"no torch counterpart for {path!r}")
    return f"{_module_key(mods)}.{_LEAF[leaf]}"


def state_dict_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """flax variables flattened with "/" keys -> the port's state_dict."""
    out: Dict[str, np.ndarray] = {}
    packed: Dict[str, Dict[int, np.ndarray]] = {}
    for path, leaf in flat.items():
        arr = np.asarray(leaf)
        key = torch_key(path)
        name = path.rsplit("/", 1)[-1]
        m = re.search(r"/(q|k|v)_proj/", path)
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:  # HWIO -> OIHW
                arr = np.transpose(arr, (3, 2, 0, 1))
            elif arr.ndim == 5:  # DHWIO -> OIDHW
                arr = np.transpose(arr, (4, 3, 0, 1, 2))
        if m:
            packed.setdefault(key, {})["qkv".index(m.group(1))] = arr
            continue
        if key in out:
            raise ValueError(f"two variables map to {key}")
        out[key] = arr
    for key, parts in packed.items():
        if sorted(parts) != [0, 1, 2]:
            raise ValueError(f"{key}: incomplete q/k/v set {sorted(parts)}")
        out[key] = np.concatenate([parts[i] for i in range(3)], axis=0)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
