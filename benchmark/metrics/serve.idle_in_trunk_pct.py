"""The share of the profiled sub-window of a traced serving run in which
the device was idle while the host was in the trunk (the program's span
``tce.engine.trunk`` and the model's stages under it: the host's dispatch
of the trunk), from the trace's host ranges and device operations."""

from harness import program


def read(ctx):
    return program.idle_pct(ctx, "serve", "tce.engine.trunk")
