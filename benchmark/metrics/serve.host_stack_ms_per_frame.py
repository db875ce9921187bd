"""The engine's host staging of the f32 frames (the program's span
``tce.engine.preprocess.stack`` in ``InferenceEngine.preprocess``: on a
CUDA engine, the host copy of the frames into the reused pinned buffer,
with any wait for its last upload; on the CPU, ``np.stack``): its host
milliseconds over the frames it staged, in the traced run's profiled
sub-window."""

from harness import program


def read(ctx):
    return program.per_unit(ctx, "serve", "tce.engine.preprocess.stack")
