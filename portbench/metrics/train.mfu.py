"""train.mfu: the least time the card needs for the pair distances that the
traced window's trained classifiers imply (work/bounds.py::train_popc: at
each greedy step mtry candidates over the final haplotypes' projections,
every sample, a popcount per 32-SNP word), at the card's popcount rate,
over the traced window's time, in %."""

from portbench.work import bounds

LAYERS = []


def read(ctx):
    if ctx.popc_rate is None:
        return None
    popc = bounds.train_popc(ctx.trained, ctx.mtry, ctx.n_samples)
    if popc <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * popc / ctx.popc_rate / ctx.window_s
