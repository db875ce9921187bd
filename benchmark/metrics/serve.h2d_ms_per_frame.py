"""The engine's upload of the f32 frames to the device (the program's span
``tce.engine.preprocess.h2d``: on a CUDA engine, the issue of the
asynchronous copy from the pinned buffer; on the CPU, the copy itself):
its host milliseconds over the frames it uploaded, in the traced run's
profiled sub-window."""

from harness import program


def read(ctx):
    return program.per_unit(ctx, "serve", "tce.engine.preprocess.h2d")
