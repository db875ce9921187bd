"""The share of the profiled sub-window of a traced serving run in which
the device was idle while the host was in the engine's input stage (the
program's span ``tce.engine.preprocess`` and its children: the host
stack, the copy, the resize), from the trace's host ranges and device
operations."""

from harness import program


def read(ctx):
    return program.idle_pct(ctx, "serve", "tce.engine.preprocess")
