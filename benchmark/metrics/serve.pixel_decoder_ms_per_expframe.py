"""The cross-modal FPN with its V-L blocks inside the trunk (the program's
span ``tce.model.pixel_decoder`` inside ``tce.engine.trunk``): its
CUDA-event milliseconds over the real expression-frames the trunk returned
(the program's counter ``engine.trunk_expframes_real``), in the traced
run's profiled sub-window."""

from harness import program


def read(ctx):
    rec = program.records(ctx) if ctx.kind == "serve" else None
    real = (rec or {}).get("counters", {}).get("engine.trunk_expframes_real")
    if not real:
        return None
    ms, _ = program.span_ms(rec, ["tce.model.pixel_decoder"], "device_ms",
                            inside="tce.engine.trunk")
    return ms / real
