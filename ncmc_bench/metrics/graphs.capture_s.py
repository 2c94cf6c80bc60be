"""Seconds the graph runner took to warm up and capture the iteration's
phases (its own counter, ``GraphRunner.capture_s``), paid in set-up."""


def read(ctx):
    return ctx["capture_s"]
