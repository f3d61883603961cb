"""post_scores.roofline: the scan engine's scoring kernel's share of its
roofline in the profiled stretch: the least time the card needs for the
stretch's ensemble scoring (work/bounds.py::scoring_work over the model's
haplotypes and each call's aligned codes, the count ens_acc.roofline
takes, whatever implements the scoring) over the device time of the
kernels named post_scores, in %. A stretch without such a kernel (the
ensemble kernel's path) reads nothing."""

from portbench.work import bounds, peaks

LAYERS = []


def read(ctx):
    if ctx.popc_rate is None:
        return None
    kernel_s = sum(s for n, s in ctx.profile["device_s_by_op"].items()
                   if "post_scores" in n)
    if kernel_s <= 0:
        return None
    least = 0.0
    for i in ctx.profile_chunks:
        nh, hw = ctx.work[i]
        w = bounds.scoring_work(nh, hw, ctx.n_alleles, ensemble=True)
        least += peaks.least_seconds(w["bytes"], w["popc"], w["flops"],
                                     ctx.popc_rate)
    return 100.0 * least / kernel_s
