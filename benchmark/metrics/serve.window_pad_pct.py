"""The padded share of the Swin window attention branch's linear work
(qkv and proj, C x 4C a token) in a traced serving run: by stage, the
program's counters ``swin.window_tokens`` (tokens fed to window attention,
the zero padding to whole windows included) less ``swin.window_tokens_real``
(the block's own tokens), counted under each stage's span
``tce.model.backbone.stage{i}``, weighted by that stage's width squared
(its family's ``channels``), over the padded total, in the profiled
sub-window. Nothing to read on a backbone without those counters."""

from harness import program


def read(ctx):
    rec = program.records(ctx) if ctx.kind == "serve" else None
    by_span = (rec or {}).get("counters_by_span", {})
    padded = pad = 0.0
    for i, c in enumerate(ctx.counts.backbone_channels(ctx.cfg)):
        got = by_span.get(f"tce.model.backbone.stage{i}", {})
        if "swin.window_tokens" not in got:
            continue
        padded += c * c * got["swin.window_tokens"]
        pad += c * c * (got["swin.window_tokens"] - got.get("swin.window_tokens_real", 0))
    return 100.0 * pad / padded if padded else None
