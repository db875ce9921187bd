"""The training step's share of the H100's bf16 peak: the useful forward
and backward FLOPs of the steps of the traced run's window (the
benchmark's count) over the window's length times 989 TFLOP/s."""


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    c, mix = ctx.counts, ctx.mix
    flops = sum(c.train_flops(ctx.cfg, int(mix["frames"]), ctx.hw, [s] * int(mix["batch"]))
                for s in ctx.tokens)
    return 100.0 * flops / (ctx.window_s * c.PEAK_BF16_FLOPS)
