"""Lanes solved over the whole window: every call's lanes, from the start
of the first call to the end of the last (host clock)."""


def read(ctx):
    return ctx["lanes"] / ctx["window_s"]
