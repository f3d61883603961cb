"""Prediction evaluation: accuracy, call rates, confusion matrix, per-allele
sensitivity/specificity/PPV/NPV (counterpart of hibag_tpu/eval/compare.py).

Equivalent of hlaCompareAllele (reference R/DataUtilities.R:1328-1633) with
the confusion-matrix EM disambiguation of double-miscalls
(HIBAG_Confusion, src/HIBAG.cpp:999-1060).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..data.allele import allele_digit, unique_alleles


def confusion_em(m: int, init_mat: np.ndarray, wrong_pairs,
                 n_iter: int = 100) -> np.ndarray:
    """EM redistribution of double-miscalls into the confusion matrix.

    init_mat: [m+1, m] (rows = predicted alleles + '...', cols = true).
    wrong_pairs: list of (t1, t2, p1, p2) index tuples (predicted indices may
    be m for '...'); each contributes 0.5 to the 4 cells initially, then EM
    re-apportions each true allele's unit between the two predicted cells.
    """
    out = init_mat.astype(np.float64).copy()
    for (t1, t2, p1, p2) in wrong_pairs:
        out[p1, t1] += 0.5
        out[p2, t1] += 0.5
        out[p1, t2] += 0.5
        out[p2, t2] += 0.5
    for _ in range(n_iter):
        tmp = out.copy()
        out = init_mat.astype(np.float64).copy()
        for (t1, t2, p1, p2) in wrong_pairs:
            for t in (t1, t2):
                f1, f2 = tmp[p1, t], tmp[p2, t]
                s = 1.0 / (f1 + f2)
                out[p1, t] += f1 * s
                out[p2, t] += f2 * s
    return out


@dataclass
class CompareResult:
    overall: dict
    confusion: np.ndarray          # [m+1, m] rounded to 2 decimals
    detail: dict                   # per-allele arrays
    alleles: list
    individual: Optional[dict] = None


def compare_alleles(true_table, pred, allele_limit=None,
                    call_threshold: float = float("nan"),
                    match_threshold: float = float("nan"),
                    max_resolution: str = "",
                    output_individual: bool = False) -> CompareResult:
    """Compare predicted vs true HLA types (hlaCompareAllele)."""
    # common samples, true-table order
    pred_pos = {s: i for i, s in enumerate(pred.sample_id)}
    rows = [(i, pred_pos[s]) for i, s in enumerate(true_table.sample_id)
            if s in pred_pos]
    ti = np.array([r[0] for r in rows], dtype=int)
    pi = np.array([r[1] for r in rows], dtype=int)

    ts1 = true_table.allele1[ti]
    ts2 = true_table.allele2[ti]
    ps1 = np.asarray(pred.allele1, dtype=object)[pi]
    ps2 = np.asarray(pred.allele2, dtype=object)[pi]
    samp_id = true_table.sample_id[ti]
    ok = np.array([a is not None and b is not None and c is not None
                   and d is not None
                   for a, b, c, d in zip(ts1, ts2, ps1, ps2)])
    ts1, ts2, ps1, ps2, samp_id = (ts1[ok], ts2[ok], ps1[ok], ps2[ok],
                                   samp_id[ok])
    prob = None
    if np.isfinite(call_threshold) and getattr(pred, "prob", None) is not None:
        prob = np.asarray(pred.prob)[pi][ok]
    matching = None
    if np.isfinite(match_threshold) and getattr(pred, "matching", None) is not None:
        matching = np.asarray(pred.matching)[pi][ok]

    # allele universe
    train_freq = None
    train_num = float("nan")
    if allele_limit is None:
        alleles = unique_alleles(np.concatenate([ts1, ts2]))
    elif hasattr(allele_limit, "hla_alleles"):
        alleles = unique_alleles(allele_limit.hla_alleles)
        train_freq = (None if allele_limit.hla_freq is None
                      else np.asarray(allele_limit.hla_freq, dtype=float))
        train_num = (len(allele_limit.sample_id)
                     if allele_limit.sample_id is not None else float("nan"))
    else:
        alleles = unique_alleles(allele_limit)

    if max_resolution not in ("", "full"):
        trunc = lambda arr: allele_digit(np.asarray(arr, dtype=object),
                                         max_resolution)
        old = list(alleles)
        ts1, ts2, ps1, ps2 = trunc(ts1), trunc(ts2), trunc(ps1), trunc(ps2)
        newa = allele_digit(np.asarray(old, dtype=object), max_resolution)
        alleles = unique_alleles(newa)
        if train_freq is not None and len(alleles) != len(old):
            tf = np.zeros(len(alleles))
            for i, a in enumerate(alleles):
                tf[i] = train_freq[np.asarray(newa) == a].sum()
            train_freq = tf

    aset = set(alleles)
    keep = np.array([(a in aset) and (b in aset) for a, b in zip(ts1, ts2)])
    ts1, ts2, ps1, ps2, samp_id = (ts1[keep], ts2[keep], ps1[keep],
                                   ps2[keep], samp_id[keep])
    if prob is not None:
        prob = prob[keep]
    if matching is not None:
        matching = matching[keep]

    m = len(alleles)
    n = len(ts1)
    aidx = {a: i for i, a in enumerate(alleles)}
    pfn = lambda x: aidx.get(x, m)  # '...' row index = m

    true_num = np.zeros(m)
    true_num_all = np.zeros(m)
    pred_num = np.zeros(m + 1)
    confusion = np.zeros((m + 1, m))
    wrong = []
    cnt_ind = cnt_haplo = cnt_call = 0
    acc_array = np.full(n, np.nan)
    ind_true = [""] * n
    ind_pred = [""] * n

    for i in range(n):
        t1, t2, p1, p2 = ts1[i], ts2[i], ps1[i], ps2[i]
        true_num_all[aidx[t1]] += 1
        true_num_all[aidx[t2]] += 1
        if prob is not None and not (prob[i] >= call_threshold):
            continue
        if matching is not None and not (matching[i] >= match_threshold):
            continue
        true_num[aidx[t1]] += 1
        true_num[aidx[t2]] += 1
        pred_num[pfn(p1)] += 1
        pred_num[pfn(p2)] += 1
        if (t1 == p1 and t2 == p2) or (t2 == p1 and t1 == p2):
            cnt_ind += 1
        s = [t1, t2]
        p = [p1, p2]
        ind_true[i] = "/".join(sorted(s))
        ind_pred[i] = "/".join(sorted([str(p1), str(p2)]))
        hnum = 0
        if s[0] == p[0] or s[0] == p[1]:
            if s[0] == p[0]:
                p[0] = ""
            else:
                p[1] = ""
            confusion[aidx[s[0]], aidx[s[0]]] += 1
            cnt_haplo += 1
            hnum += 1
        if s[1] == p[0] or s[1] == p[1]:
            confusion[aidx[s[1]], aidx[s[1]]] += 1
            cnt_haplo += 1
            hnum += 1
        acc_array[i] = 0.5 * hnum
        s = [t1, t2]
        p = [p1, p2]
        if hnum == 1:
            if s[0] == p[0] or s[0] == p[1]:
                other = p[1] if s[0] == p[0] else p[0]
                confusion[pfn(other), aidx[s[1]]] += 1
            else:
                other = p[1] if s[1] == p[0] else p[0]
                confusion[pfn(other), aidx[s[0]]] += 1
        elif hnum == 0:
            wrong.append((aidx[s[0]], aidx[s[1]], pfn(p[0]), pfn(p[1])))
        cnt_call += 1

    overall = {
        "total.num.ind": n,
        "crt.num.ind": cnt_ind,
        "crt.num.haplo": cnt_haplo,
        "acc.ind": cnt_ind / cnt_call if cnt_call else float("nan"),
        "acc.haplo": 0.5 * cnt_haplo / cnt_call if cnt_call else float("nan"),
        "call.threshold": call_threshold if np.isfinite(call_threshold) else 0,
        "n.call": cnt_call,
        "call.rate": cnt_call / n if n else float("nan"),
    }

    conf = np.round(confusion_em(m, confusion, wrong), 2)

    with np.errstate(divide="ignore", invalid="ignore"):
        diag = np.diag(conf[:m])
        sens = diag / true_num
        spec = 1 - (pred_num[:m] - diag) / (2 * cnt_call - true_num)
        accuracy = (sens * true_num + spec * (2 * cnt_call - true_num)) / (
            2 * cnt_call)
        ppv = diag / conf[:m].sum(axis=1)
        npv = 1 - (true_num - diag) / (2 * n - conf[:m].sum(axis=1))
        call_rate = np.where(true_num_all > 0, true_num / true_num_all, 0)
    bad = call_rate <= 0
    for arr in (sens, spec, ppv, npv, accuracy):
        arr[bad] = np.nan

    offdiag = conf[:m + 1].copy()
    np.fill_diagonal(offdiag[:m], 0)
    mis_max = offdiag.max(axis=0)
    mis_idx = offdiag.argmax(axis=0)
    miscall = np.array(
        [([*alleles, "..."][mis_idx[j]] if mis_max[j] > 0 else None)
         for j in range(m)], dtype=object)
    with np.errstate(divide="ignore", invalid="ignore"):
        mis_prop = mis_max / offdiag.sum(axis=0)

    detail = {
        "allele": np.asarray(alleles, dtype=object),
        "valid.num": true_num_all,
        "valid.freq": true_num_all / true_num_all.sum() if true_num_all.sum() else true_num_all,
        "call.rate": call_rate,
        "accuracy": accuracy,
        "sensitivity": sens,
        "specificity": spec,
        "ppv": ppv,
        "npv": npv,
        "miscall": miscall,
        "miscall.prop": mis_prop,
    }
    if train_freq is not None:
        detail["train.num"] = 2 * train_freq * train_num
        detail["train.freq"] = train_freq

    individual = None
    if output_individual:
        individual = {"sample.id": samp_id, "true.hla": np.asarray(ind_true)[:n],
                      "pred.hla": np.asarray(ind_pred)[:n],
                      "accuracy": acc_array}
    return CompareResult(overall=overall, confusion=conf, detail=detail,
                         alleles=list(alleles), individual=individual)
