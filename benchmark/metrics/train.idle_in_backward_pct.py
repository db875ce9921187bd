"""The share of the profiled steps' window of a traced training run in
which the device was idle while the host was in the step's backward (the
program's span ``tce.train.backward``, ``total.backward()``), from the
trace's host ranges and device operations."""

from harness import program


def read(ctx):
    return program.idle_pct(ctx, "train", "tce.train.backward")
