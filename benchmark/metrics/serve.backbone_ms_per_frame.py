"""The backbone (``InferenceEngine.backbone``: ResNet-50 on each frame, or
Video-Swin on the clip): its span's milliseconds (CUDA events around each
call) over the frames it ran, padding frames included, in the traced
run's window."""


def read(ctx):
    spans = ctx.spans.get("backbone", []) if ctx.kind == "serve" else []
    frames = sum(u for _, u in spans)
    return sum(ms for ms, _ in spans) / frames if frames else None
