"""Mean ms of one NCMC micro-step replay (phase 'micro'), from CUDA events
around each replay in the traced run's window."""


def read(ctx):
    ms = ctx["phase_ms"].get("micro")
    return sum(ms) / len(ms) if ms else None
