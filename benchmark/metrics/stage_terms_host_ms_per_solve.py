"""Host self milliseconds of the `stage_terms` spans (the keypoint and
limit terms, the static step costs, the trajectory's FK) in one untraced
call recorded by `spans.measure`."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "stage_terms")
