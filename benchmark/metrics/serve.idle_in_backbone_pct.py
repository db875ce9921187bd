"""The share of the profiled sub-window of a traced serving run in which
the device was idle while the host was in the backbone (the program's span
``tce.model.backbone`` and its stages: the host's dispatch of the backbone
and the waits inside it, such as a blocking upload), from the trace's host
ranges and device operations."""

from harness import program


def read(ctx):
    return program.idle_pct(ctx, "serve", "tce.model.backbone")
