"""The engine's copy of the stacked f32 frames to the device (the
program's span ``tce.engine.preprocess.h2d``, a pageable host-to-device
copy): its host milliseconds over the frames it copied, in the traced
run's profiled sub-window."""

from harness import program


def read(ctx):
    return program.per_unit(ctx, "serve", "tce.engine.preprocess.h2d")
