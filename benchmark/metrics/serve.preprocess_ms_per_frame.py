"""The engine's input stage (``InferenceEngine.preprocess``: the host
stack of the frames, the copy to the device, resize, normalise, pad): its
span's milliseconds (CUDA events around each call) over the frames it
took, padding frames included, in the traced run's window."""


def read(ctx):
    spans = ctx.spans.get("preprocess", []) if ctx.kind == "serve" else []
    frames = sum(u for _, u in spans)
    return sum(ms for ms, _ in spans) / frames if frames else None
