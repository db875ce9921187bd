"""Visualization colormap: the port's copy of
``tce_rvos_tpu/tools/colormap.py``, a fixed table of 79 visually distinct
colours made by a golden-ratio walk in HSV."""

from __future__ import annotations

import colorsys

import numpy as np


def colormap(rgb: bool = False, maximum: int = 255, n: int = 79) -> np.ndarray:
    """[n, 3] colours, RGB or (by default) BGR, scaled to ``maximum``."""
    colors = []
    h = 0.0
    for i in range(n):
        h = (h + 0.618033988749895) % 1.0
        s = 0.65 if i % 2 == 0 else 0.9
        v = 0.95 if i % 3 else 0.7
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        colors.append([r, g, b] if rgb else [b, g, r])
    return (np.asarray(colors) * maximum).astype(np.float64)
