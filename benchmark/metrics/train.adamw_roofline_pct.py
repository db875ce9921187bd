"""The flat AdamW update kernel's share of its roofline in the profiled
steps of a traced training run: 28 bytes a trained float32 parameter (p
read and written, the gradient read, both moments read and written) over
3.35 TB/s, for each launch, over the kernel's device time."""

KERNEL = r"flat_adamw_kernel<"


def read(ctx):
    tr = ctx.trace
    if ctx.kind != "train" or tr is None:
        return None
    seconds, launches = tr.kernel_seconds(KERNEL)
    if not seconds:
        return None
    return 100.0 * launches * ctx.counts.adamw_bound_s(ctx.params) / seconds
