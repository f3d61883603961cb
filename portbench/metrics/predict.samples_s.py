"""predict.samples_s: samples imputed per second in the traced window: the
samples of its predict() calls over its host-clock length, the window
ending when its last call has returned. It is the whole call's rate as
the caller sees it, host alignment included; the host's speed moves it
from run to run (PERF.md), so it is read here and bounds nothing."""

LAYERS = []


def read(ctx):
    n = sum(len(c[3][2]) for c in ctx.calls)
    return n / ctx.window_s if ctx.window_s > 0 and n else None
