"""The share of the backbone's dispatches replayed from CUDA graphs: 100 x
``engine.backbone_graph_replays`` over every dispatch (replayed; run
eagerly at a window shape's first dispatch, which captures it,
``engine.backbone_graph_captures``; sent eagerly by the engine's gate,
``engine.backbone_graph_eager``), the program's counters over the traced
run's profiled sub-window. Nothing to read from a program without those
counters."""

from harness import program

COUNTERS = ("engine.backbone_graph_replays", "engine.backbone_graph_captures",
            "engine.backbone_graph_eager")


def read(ctx):
    rec = program.records(ctx) if ctx.kind == "serve" else None
    counters = (rec or {}).get("counters", {})
    dispatches = sum(counters.get(k, 0) for k in COUNTERS)
    if not dispatches:
        return None
    return 100.0 * counters.get(COUNTERS[0], 0) / dispatches
