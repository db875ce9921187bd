"""The 2D MSDA kernels' share of their roofline in the profiled steps of
a traced training run: the least time of every forward and backward MSDA
call of those steps (the benchmark's bound from the shapes: encoder, FTF
and decoder calls over the batch's clip-frames) over the device time of
the forward and backward kernels. No reading when the launches in the
trace are not the calls counted."""

KERNELS = (r"msda_fwd_kernel<", r"msda_bwd_kernel<")
BF16 = 2


def read(ctx):
    tr = ctx.trace
    if ctx.kind != "train" or tr is None or not ctx.profiled_steps:
        return None
    mix, c = ctx.mix, ctx.counts
    n = int(mix["batch"]) * int(mix["frames"])
    calls = len(c.trunk_msda_calls(ctx.cfg, 1, [(1, 1)] * 4)) * ctx.profiled_steps
    seconds, bound = 0.0, 0.0
    for pattern, backward in zip(KERNELS, (False, True)):
        s, launches = tr.kernel_seconds(pattern)
        if launches != calls:
            return None
        seconds += s
        bound += ctx.profiled_steps * c.trunk_msda_bound_s(ctx.cfg, n, ctx.hw, BF16, backward)
    return 100.0 * bound / seconds if seconds else None
