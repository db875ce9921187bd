"""The deformable transformer inside the trunk (the program's spans
``tce.model.encoder``, FTF included, and ``tce.model.decoder``, IQT
included, inside ``tce.engine.trunk``): their CUDA-event milliseconds over
the real expression-frames the trunk returned (the program's counter
``engine.trunk_expframes_real``), in the traced run's profiled
sub-window."""

from harness import program


def read(ctx):
    rec = program.records(ctx) if ctx.kind == "serve" else None
    real = (rec or {}).get("counters", {}).get("engine.trunk_expframes_real")
    if not real:
        return None
    ms, _ = program.span_ms(rec, ["tce.model.encoder", "tce.model.decoder"], "device_ms",
                            inside="tce.engine.trunk")
    return ms / real
