"""The training check's matching. The matcher picks each clip's query by an
argmin over five costs that sit near ties at random weights, so a rounding
can flip it, and a flip moves the loss and every gradient after it: the
reference could then not follow the side it judges. So during the checked
steps the side in the program's place (the port, or the control) records
what its matcher picked and from what (``record``), and the reference
takes those picks (``follow``), recording what its own matcher was given.
The stage this skips is checked by itself,
after the window: each recorded pick's regret on the reference matcher's
costs of the same inputs (``own_regrets``), where a sound matcher reads 0;
and, read only, each pick's regret on the reference's own costs, where
rounding flips near ties. A regret is (cost of the pick - least cost) /
(largest - least cost), 0 where the two pick the same."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass
class Call:
    pick: torch.Tensor
    args: Tuple
    kwargs: Dict


def _detached(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


def regrets(cost: torch.Tensor, pick: torch.Tensor) -> List[float]:
    cost = cost.float()
    pick = pick.to(cost.device)
    rows = torch.arange(cost.shape[0], device=cost.device)
    lo, hi = cost.min(1).values, cost.max(1).values
    return ((cost[rows, pick] - lo) / (hi - lo).clamp(min=1e-12)).tolist()


@contextlib.contextmanager
def record(module):
    """Records ``module.match``'s answers and their arguments, in call order."""
    saved, calls = module.match, []

    def match(*args, **kwargs):
        out = saved(*args, **kwargs)
        calls.append(Call(out.detach(), tuple(_detached(a) for a in args),
                          {k: _detached(v) for k, v in kwargs.items()}))
        return out

    module.match = match
    try:
        yield calls
    finally:
        module.match = saved


def own_regrets(calls: List[Call], costs_fn: Callable) -> List[float]:
    """Each recorded pick's regret on ``costs_fn``'s costs of its own inputs."""
    out = []
    for c in calls:
        out.extend(regrets(costs_fn(*c.args, **c.kwargs), c.pick))
    return out


@contextlib.contextmanager
def follow(module, costs_fn, calls: List[Call]):
    """``module.match`` answers the recorded picks in call order; yields
    (the regret of each against ``costs_fn``'s costs of the same arguments,
    the reference's own ``Call``s)."""
    saved, out, own = module.match, [], []

    def match(*args, **kwargs):
        cost = costs_fn(*args, **kwargs)
        if len(own) >= len(calls):
            raise RuntimeError("the reference matched more often than the side it follows")
        pick = calls[len(own)].pick.to(cost.device)
        own.append(Call(pick, tuple(_detached(a) for a in args),
                        {k: _detached(v) for k, v in kwargs.items()}))
        out.extend(regrets(cost, pick))
        return pick

    module.match = match
    try:
        yield out, own
    finally:
        module.match = saved
