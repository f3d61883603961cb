"""Diagnostic plots (hlaReportPlot / plot.hlaAttrBagObj / hlaLDMatrix).

Matplotlib equivalents of the reference's ggplot figures
(R/DataUtilities.R:2429-2578, R/HIBAG.R:1602-1660): matching-proportion
violins, call-rate vs accuracy curves, accuracy vs call-threshold curves,
model SNP-usage maps, and LD heatmaps. Every function returns the axes and
accepts ``out_fn`` to save directly (headless-safe).

The port's copy of hibag_tpu/eval/plots.py, so that the port imports nothing
of that package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _ax(ax):
    if ax is not None:
        return ax, None
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 5))
    return ax, fig


def _finish(fig, out_fn):
    if fig is not None and out_fn:
        fig.tight_layout()
        fig.savefig(out_fn, dpi=120)
        import matplotlib.pyplot as plt
        plt.close(fig)


def plot_matching(pred=None, model=None, log_scale: bool = True,
                  ax=None, out_fn: Optional[str] = None):
    """Violin plot of matching proportions: training vs test
    (hlaReportPlot fig="matching"). Marks the training 1% quantile (the
    out-of-distribution cutoff recommended by the reference)."""
    ax, fig = _ax(ax)
    data, labels = [], []
    cut = None
    if model is not None and getattr(model, "matching", None) is not None:
        m = np.asarray(model.matching, dtype=float)
        cut = np.nanquantile(m, 0.01)
        data.append(np.log10(np.maximum(m, 1e-128)) if log_scale else m)
        labels.append("training")
    if pred is not None and getattr(pred, "matching", None) is not None:
        m = np.asarray(pred.matching, dtype=float)
        data.append(np.log10(np.maximum(m, 1e-128)) if log_scale else m)
        labels.append("test")
    if not data:
        raise ValueError("need a model with matching and/or a prediction")
    ax.violinplot(data, showmedians=True)
    for i, d in enumerate(data):
        ax.scatter(np.full(len(d), i + 1)
                   + np.random.default_rng(0).uniform(-0.08, 0.08, len(d)),
                   d, s=4, alpha=0.5, color="k")
    ax.set_xticks(range(1, len(labels) + 1), labels)
    ax.set_ylabel("log10(matching proportion)" if log_scale
                  else "matching proportion")
    if cut is not None:
        ax.axhline(np.log10(cut) if log_scale else cut, color="red",
                   ls="--", lw=1,
                   label="1% quantile of training matching")
        ax.legend(fontsize=8)
    _finish(fig, out_fn)
    return ax


def plot_call_rate(pred, truth, n_points: int = 50, ax=None,
                   out_fn: Optional[str] = None):
    """Accuracy vs call rate as the posterior-probability threshold sweeps
    (hlaReportPlot fig="call.rate")."""
    from .compare import compare_alleles
    ax, fig = _ax(ax)
    probs = np.asarray(pred.prob, dtype=float)
    ths = np.quantile(probs[np.isfinite(probs)],
                      np.linspace(0, 0.95, n_points))
    xs, ys = [], []
    for t in np.unique(ths):
        r = compare_alleles(truth, pred, call_threshold=float(t))
        xs.append(r.overall["call.rate"])
        ys.append(r.overall["acc.haplo"])
    ax.plot(xs, ys, "o-", ms=3)
    ax.set_xlabel("call rate")
    ax.set_ylabel("accuracy (per allele)")
    _finish(fig, out_fn)
    return ax


def plot_call_threshold(pred, truth, n_points: int = 50, ax=None,
                        out_fn: Optional[str] = None):
    """Accuracy vs posterior-probability call threshold
    (hlaReportPlot fig="call.threshold")."""
    from .compare import compare_alleles
    ax, fig = _ax(ax)
    ths = np.linspace(0.0, 0.95, n_points)
    ys = []
    for t in ths:
        r = compare_alleles(truth, pred, call_threshold=float(t))
        ys.append(r.overall["acc.haplo"])
    ax.plot(ths, ys, "o-", ms=3)
    ax.set_xlabel("call threshold (posterior probability)")
    ax.set_ylabel("accuracy (per allele)")
    _finish(fig, out_fn)
    return ax


def plot_model(model, ax=None, out_fn: Optional[str] = None):
    """SNP usage frequency vs genomic position (plot.hlaAttrBagObj,
    R/HIBAG.R:1602)."""
    from ..models.introspect import summarize
    ax, fig = _ax(ax)
    s = summarize(model)
    pos = np.asarray(model.snp_position, dtype=float) / 1e6
    ax.vlines(pos, 0, s["snp.hist"], lw=0.8)
    ax.set_xlabel("SNP position (Mb)")
    ax.set_ylabel("frequency of use")
    ax.set_title(f"{model.locus}: {model.n_classifiers} classifiers")
    _finish(fig, out_fn)
    return ax


def plot_ld_heatmap(r2: np.ndarray, ax=None, out_fn: Optional[str] = None):
    """SNP LD r² heatmap (hlaLDMatrix figure)."""
    ax, fig = _ax(ax)
    im = ax.imshow(r2, cmap="viridis", vmin=0, vmax=1, origin="lower")
    ax.figure.colorbar(im, ax=ax, label="r²")
    ax.set_xlabel("SNP index")
    ax.set_ylabel("SNP index")
    _finish(fig, out_fn)
    return ax
