"""Mixed precision (counterpart of ``tce_rvos_tpu/utils/precision.py``).

bf16 is entered once at the boundary: the engine casts the module's
floating parameters and buffers and the video. What must stay exact stays
float32 by construction, as in the JAX package: GroupNorm statistics,
position encodings (cast at the point of use by ``layers.with_pos``),
reference-point and box coordinate math (pinned to float32 in the
transformer) and MSDA sampling locations and weights.
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"compute_dtype must be one of {sorted(_DTYPES)}, got {name!r}"
        ) from None
