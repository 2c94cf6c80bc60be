"""Mean ms of one MD step replay (phase 'md'), from CUDA events around each
replay in the traced run's window."""


def read(ctx):
    ms = ctx["phase_ms"].get("md")
    return sum(ms) / len(ms) if ms else None
