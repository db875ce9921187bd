"""The backbone families of the reference, found by name.

A family is one module ``backbone_<family>.py`` of this package. It
defines:

  * ``CONFIGS``: the backbone names it builds, each with its spec;
  * ``TEMPORAL``: True if its network takes clips [b, 3, t, H, W], False
    if it takes frames [N, 3, H, W];
  * ``build(name, cfg) -> (network, strides, channels)`` from the
    reference's ``ModelConfig``; the network returns res2..res5 as four
    per-frame maps [(b t), C, h, w];
  * ``channels(name)``: the four maps' channels;
  * ``flops(name, cfg, t, hw) -> (FLOPs, FLOPs of the first convolution,
    the four maps' sizes)`` of a t-frame clip at padded size ``hw``, from a
    configuration file's keys, by ``harness/counts.py``'s rules: 2 FLOPs a
    multiply-add of the matrix products and convolutions, the real frames
    only, no window padding.

It may set ``DILATION = True`` (it takes ``--dilation``: only ResNet
does), and bring ``init_module(module, generator)``, which
``init_weights`` calls, in its module-order loop, on each module that is
none of the model's shared types (linear, convolution, embedding,
attention), so that a family initialises types of its own.
"""

from __future__ import annotations

import functools
import importlib
import pkgutil
import types
from pathlib import Path
from typing import Mapping


@functools.lru_cache(maxsize=None)
def families() -> Mapping[str, types.ModuleType]:
    """{backbone name: its family module}, over every ``backbone_*``
    module of the package, imported once, in file-name order. Two modules
    that claim one name raise ``ValueError`` naming both."""
    found = {}
    for info in pkgutil.iter_modules([str(Path(__file__).parent)]):
        if not info.name.startswith("backbone_"):
            continue
        mod = importlib.import_module(f"{__package__}.{info.name}")
        for name in mod.CONFIGS:
            if name in found:
                raise ValueError(f"backbone {name!r} is claimed by both "
                                 f"{found[name].__name__} and {mod.__name__}")
            found[name] = mod
    return types.MappingProxyType(found)


def family(name: str) -> types.ModuleType:
    """The family of the backbone ``name``; for a name that no family
    builds, ``ValueError`` naming the flag and every known name."""
    known = families()
    if name not in known:
        raise ValueError(f"--backbone: unknown backbone {name!r}; the known ones are "
                         + ", ".join(known))
    return known[name]
