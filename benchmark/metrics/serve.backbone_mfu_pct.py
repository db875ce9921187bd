"""The backbone's share of the H100's bf16 peak in a traced serving run:
its useful FLOPs (its family's count, ``counts.backbone_flops``, at the
frames of each of the program's ``tce.model.backbone`` spans and the padded
model size) over those spans' CUDA-event seconds (the host's without CUDA)
times 989 TFLOP/s, in the profiled sub-window. A compute-bound layer of
matrix products and no kernel of the port's own: its share of the peak is
its roofline share."""

from harness import program


def read(ctx):
    rec = program.records(ctx) if ctx.kind == "serve" else None
    if rec is None:
        return None
    flops = seconds = 0.0
    for s in rec["spans"]:
        if s["name"] == "tce.model.backbone" and s["units"]:
            flops += ctx.counts.backbone_flops(ctx.cfg, int(s["units"]), ctx.hw)[0]
            ms = s["device_ms"] if s["device_ms"] is not None else s["host_ms"]
            seconds += ms * 1e-3
    if not seconds:
        return None
    return 100.0 * flops / (seconds * ctx.counts.PEAK_BF16_FLOPS)
