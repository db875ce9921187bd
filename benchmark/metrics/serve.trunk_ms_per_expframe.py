"""The text-conditioned trunk (``InferenceEngine.trunk``: text encoder,
fusion, FTF encoder, IQT decoder, FPN with V-L blocks, dynamic mask head):
its span's milliseconds (CUDA events around each call) over the real
expression-frames of the requests of the traced run's window (padded
frames and expressions not counted)."""


def read(ctx):
    spans = ctx.spans.get("trunk", []) if ctx.kind == "serve" else []
    work = sum(req.frames * req.expressions for req, _ in ctx.get("done", []))
    return sum(ms for ms, _ in spans) / work if spans and work else None
