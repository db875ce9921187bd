"""The trainer's wait for each step's device work (the program's span
``tce.train.read_metrics`` in ``engine.train_one_epoch``, where the step's
metrics are read to the host): its host milliseconds a step, over the
traced run's profiled steps."""

from harness import program


def read(ctx):
    return program.per_unit(ctx, "train", "tce.train.read_metrics")
