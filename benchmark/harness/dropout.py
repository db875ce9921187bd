"""Dropout masks that the port and the reference draw alike.

The training check follows the port's first steps with the reference,
which cannot follow torch's dropout: its masks depend on how each kernel
maps random numbers to elements, which differs with the dtype and the
layout. During those steps only, ``seeded_dropout`` replaces
``torch.nn.functional.dropout`` (what every ``nn.Dropout`` calls) by the
same operation, a Bernoulli(1 - p) keep mask scaled by 1 / (1 - p), whose
k-th call in the process draws its mask from a generator seeded by the
run's seed and k. The port's steps and the reference's then drop the same
elements; the window runs torch's own dropout."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .traffic import rng


@contextlib.contextmanager
def seeded_dropout(seed: int):
    saved = F.dropout
    calls = [0]

    def dropout(x, p=0.5, training=True, inplace=False):
        if not training or p == 0.0:
            return x
        g = torch.Generator(device=x.device)
        g.manual_seed(int(rng(seed, 1000 + calls[0]).integers(0, 2**62)))
        calls[0] += 1
        keep = torch.rand(x.shape, generator=g, device=x.device) >= p
        out = x * keep.to(x.dtype) * (1.0 / (1.0 - p))
        return x.copy_(out) if inplace else out

    F.dropout = dropout
    try:
        yield calls
    finally:
        F.dropout = saved
