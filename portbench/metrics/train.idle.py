"""train.idle: the share of a stretch of one batch of training in which no
kernel or copy ran on the card, in %: 1 - (union of the device's busy
intervals) / the stretch's host-clock length. The stretch (the set-up's
block of classifiers) is traced on the device alone: recording every host
operation as well lengthened it by 14-41% on an H100."""

LAYERS = []


def read(ctx):
    p = ctx.profile
    if p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
