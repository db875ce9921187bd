"""The engine's host stack of the f32 frames (the program's span
``tce.engine.preprocess.stack``, around ``np.stack`` in
``InferenceEngine.preprocess``): its host milliseconds over the frames it
stacked, in the traced run's profiled sub-window."""

from harness import program


def read(ctx):
    return program.per_unit(ctx, "serve", "tce.engine.preprocess.stack")
