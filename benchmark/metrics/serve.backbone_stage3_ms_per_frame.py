"""The third Swin stage (the program's span ``tce.model.backbone.stage2``:
stages are counted from 0, so the third is ``stage2``; in Swin-L its 18
blocks at 768 wide and its output norm): its CUDA-event milliseconds over
the frames it ran, in the traced run's profiled sub-window. Nothing to read
on a backbone without that span."""

from harness import program


def read(ctx):
    return program.per_unit(ctx, "serve", "tce.model.backbone.stage2", "device_ms")
