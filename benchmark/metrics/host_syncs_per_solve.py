"""Host reads of device values in one untraced call: the program's own
counter (`compilemeter.SYNCS`: the fleet's loop and trial guards, and the
dispatch's copies of the spec to the host), read by `spans.measure`."""

from benchmark import spans


def read(ctx):
    m = spans.measure(ctx)
    return float(m["syncs"]) if m else None
