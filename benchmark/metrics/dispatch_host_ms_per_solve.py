"""Host self milliseconds of the `dispatch` span (`mesh.solve_batch`: the
spec's fingerprint, the memo, the route; not the spans inside it) in one
untraced call recorded by `spans.measure`."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "dispatch")
