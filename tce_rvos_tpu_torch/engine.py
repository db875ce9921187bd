"""Training loop (counterpart of ``tce_rvos_tpu/engine.py::train_one_epoch``):
one train step per batch, the loss dict logged through ``MetricLogger``,
and a stop on a non-finite loss.

Not ported yet: the evaluation loops (``evaluate_yvos``, ``evaluate_a2d``).
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Dict, Optional

from tce_rvos_tpu_torch.utils.logging import MetricLogger, SmoothedValue


def train_one_epoch(
    state,
    step_fn: Callable,
    loader,
    epoch: int,
    print_freq: int = 10,
    max_steps: Optional[int] = None,
):
    """Runs ``step_fn(state, batch)`` (``parallel/train_step.py``) over
    ``loader`` with the model in train mode (dropout on). Returns the state
    and the epoch's global averages of the metrics. A loss that is not
    finite prints the metrics and stops training (exit code 1). The
    averages include the logger's seconds per step (``time``) and, of them,
    the wait for the next batch (``data``)."""
    state.model.train()
    logger = MetricLogger()
    logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    header = f"Epoch: [{epoch}]"

    for step, batch in enumerate(logger.log_every(loader, print_freq, header)):
        if max_steps is not None and step >= max_steps:
            break
        batch = {k: v for k, v in batch.items() if k != "image_ids"}
        state, metrics = step_fn(state, batch)
        host: Dict[str, float] = {k: float(v) for k, v in metrics.items()}
        loss = host.pop("loss")
        if not math.isfinite(loss):
            print(f"Loss is {loss}, stopping training")
            print(host)
            sys.exit(1)
        logger.update(loss=loss, **host)

    stats = {k: m.global_avg for k, m in logger.meters.items()}
    stats.update(time=logger.iter_time.global_avg, data=logger.data_time.global_avg)
    return state, stats
