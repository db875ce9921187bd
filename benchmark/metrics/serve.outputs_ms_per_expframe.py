"""The engine's copies of each trunk dispatch's outputs to numpy (the
program's span ``tce.engine.outputs``: pageable device-to-host copies,
waiting for the trunk's device work included): its host milliseconds over
the real expression-frames it returned, in the traced run's profiled
sub-window."""

from harness import program


def read(ctx):
    return program.per_unit(ctx, "serve", "tce.engine.outputs")
