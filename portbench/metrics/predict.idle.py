"""predict.idle: the share of a stretch of predict() calls in which no
kernel or copy ran on the card, in %: 1 - (union of the device's busy
intervals) / the stretch's host-clock length, traced on the device alone
(host operations unrecorded, so the host runs at its own pace)."""

LAYERS = []


def read(ctx):
    p = ctx.profile
    if p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
