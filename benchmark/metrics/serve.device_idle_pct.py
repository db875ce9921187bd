"""The share of the profiled sub-window of a traced serving run in which no
operation ran on the device (the union of the device operations'
intervals in the trace, against the sub-window's length by the host's
clock)."""


def read(ctx):
    tr = ctx.trace
    if ctx.kind != "serve" or tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
