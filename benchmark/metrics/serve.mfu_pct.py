"""The serving model step's share of the H100's bf16 peak: the useful
FLOPs of the requests completed in the traced run's window (the
benchmark's count at each window's real frames and each caption's tokens)
over the window's length times 989 TFLOP/s."""

from harness.check import windows
from reference.text_encoder import tokenize


def read(ctx):
    if ctx.kind != "serve" or not ctx.done:
        return None
    c, flops = ctx.counts, 0.0
    for req, _ in ctx.done:
        tokens = [int(tokenize([cap])[1].sum()) for cap in req.captions]
        for _, core in windows(req.frames, ctx.mix):
            flops += c.forward_flops(ctx.cfg, core, ctx.hw, tokens)
    return 100.0 * flops / (ctx.window_s * c.PEAK_BF16_FLOPS)
