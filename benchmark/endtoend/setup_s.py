"""Process start to the end of warm-up (host clock)."""


def read(ctx):
    return ctx["setup_s"]
