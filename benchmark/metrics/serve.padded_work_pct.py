"""The share of the trunk's expression-frames that were padding (whole
videos rounded up to ``t_bucket`` frames, expression chunks up to a power
of two): 100 x (1 - ``engine.trunk_expframes_real`` /
``engine.trunk_expframes``), the program's counters over the traced run's
profiled sub-window."""

from harness import program


def read(ctx):
    rec = program.records(ctx) if ctx.kind == "serve" else None
    counters = (rec or {}).get("counters", {})
    done, real = counters.get("engine.trunk_expframes"), counters.get("engine.trunk_expframes_real")
    if not done or real is None:
        return None
    return 100.0 * (1.0 - real / done)
