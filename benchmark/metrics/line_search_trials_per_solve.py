"""Line-search trials of one untraced call: the fleet's own counter
(`fleet.TRIALS`, each trial once for the whole batch)."""


def read(ctx):
    counts = ctx.get("counts")
    return float(counts["trials"]) if counts else None
