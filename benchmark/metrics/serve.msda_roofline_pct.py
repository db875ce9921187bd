"""The 2D MSDA forward kernel's share of its roofline in the profiled
sub-window of a traced serving run: the least time of every MSDA call the
profiled requests needed (the benchmark's bound from the call's shapes:
encoder, FTF and decoder calls over the request's real expressions times
real frames, whatever padding or chunking the engine adds) over the device
time of the kernels named below. No reading when the launches in the trace
are not the 12 calls of each trunk dispatch (the request's windows, each in
chunks of ``exp_batch`` expressions)."""

KERNEL = r"msda_fwd_kernel<"
BF16 = 2


def dispatches(req, mix) -> int:
    """The trunk dispatches of a request: one a window and a chunk of
    ``exp_batch`` expressions."""
    from harness.check import windows

    return len(windows(req.frames, mix)) * -(-req.expressions // int(mix["exp_batch"]))


def read(ctx):
    tr = ctx.trace
    if ctx.kind != "serve" or tr is None:
        return None
    seconds, launches = tr.kernel_seconds(KERNEL)
    reqs = [req for req, _ in ctx.profiled]
    calls = len(ctx.counts.trunk_msda_calls(ctx.cfg, 1, [(1, 1)] * 4))
    if not seconds or launches != calls * sum(dispatches(r, ctx.mix) for r in reqs):
        return None
    # the bound is linear in N, so the requests' real N sum to one bound
    n = sum(r.expressions * r.frames for r in reqs)
    return 100.0 * ctx.counts.trunk_msda_bound_s(ctx.cfg, n, ctx.hw, BF16) / seconds
