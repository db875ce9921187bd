"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Weights are made with numpy from a seed and given to both frameworks. Every
leaf gets seeded noise: at the JAX package's own init the MSDA offset and
attention kernels are zero, which makes the attention weights uniform and
the top-k sample export a tie, and the parity tests weak.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util


def _leaf(path: str, shape, rng: np.random.RandomState) -> np.ndarray:
    name = path.rsplit("/", 1)[-1]
    if name == "running_var":
        x = 0.5 + rng.rand(*shape)
    elif name == "scale" or (path.startswith("frozen/") and name == "weight"):
        x = 1.0 + 0.1 * rng.randn(*shape)
    elif name in ("bias", "running_mean"):
        x = 0.1 * rng.randn(*shape)
    elif name == "kernel":
        x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "embedding":
        x = 0.5 * rng.randn(*shape)
    else:  # query_embed, level_embed, memory_bus, memory_pos
        x = rng.randn(*shape)
    return x.astype(np.float32)


def random_variables(init_fn, *args, seed: int = 0, **kwargs) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Variables with the structure ``init_fn`` would make (traced only,
    never compiled) and seeded random values. Returns (variables,
    flat numpy dict with "/" keys)."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args, **kwargs)
    flat_shapes = traverse_util.flatten_dict(shapes, sep="/")
    rng = np.random.RandomState(seed)
    flat = {k: _leaf(k, flat_shapes[k].shape, rng) for k in sorted(flat_shapes)}
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return variables, flat


def prefixed(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Give a sub-module's variables the path they have inside the full
    model: "params/x" -> "params/<prefix>/x"."""
    out = {}
    for k, v in flat.items():
        col, _, rest = k.partition("/")
        out[f"{col}/{prefix}/{rest}"] = v
    return out


def sub_state_dict(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` under ``prefix.``, with the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def assert_close(got, want, rtol: float, atol: float, name: str = "") -> None:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=name)
