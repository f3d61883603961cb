"""predict.mfu: the whole call's share of the card's peak: the least time
the card needs for each call of the traced window (the ensemble's scoring
work, plus the cohort's codes in and the outputs out:
work/bounds.py::predict_call_work) over the calls' host-clock time, in %.
It bounds a claim once a later change fuses or removes a kernel."""

from portbench.work import bounds, peaks

LAYERS = []


def read(ctx):
    if ctx.popc_rate is None:
        return None
    least = spent = 0.0
    for t0, t1, i, _ in ctx.calls:
        nh, hw = ctx.work[i]
        w = bounds.predict_call_work(nh, hw, ctx.n_alleles, ctx.n_snp)
        least += peaks.least_seconds(w["bytes"], w["popc"], w["flops"],
                                     ctx.popc_rate)
        spent += t1 - t0
    return 100.0 * least / spent if spent > 0 else None
