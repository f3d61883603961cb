"""Model publishing, OOB evaluation, multi-model prediction merging
(counterpart of hibag_tpu/models/publish.py).

Equivalents of hlaPublish (reference R/DataUtilities.R:1948-2021),
hlaOutOfBag (R/HIBAG.R:1275-1386), hlaPredMerge (R/HIBAG.R:825-1023) and
hlaModelFiles (R/DataUtilities.R:2028). `out_of_bag` predicts through the
port's `predict` on a device (the ensemble kernel on the card, one
classifier per call). `model_to_robj` and `save_rdata` write R's
hlaAttrBagObj through the port's io/rdata.py.
"""

from __future__ import annotations

import glob as _glob
from typing import Optional, Sequence

import numpy as np

from ..data.allele import allele_digit, unique_alleles
from .model import AttrBagModel
from .predict import PredictionResult


def publish(model: AttrBagModel, platform: Optional[str] = None,
            information: Optional[str] = None, warning: Optional[str] = None,
            rm_unused_snp: bool = True, anonymize: bool = True) -> AttrBagModel:
    """Prepare a model for distribution: drop unused SNPs (reindexing every
    classifier), anonymize sample ids/bootstrap counts, attach metadata."""
    out = AttrBagModel(**{**model.__dict__})
    out.classifiers = [type(c)(**{**c.__dict__}) for c in model.classifiers]
    out.appendix = dict(model.appendix)
    for key, val in (("platform", platform), ("information", information),
                     ("warning", warning)):
        if val is not None:
            out.appendix[key] = val

    if rm_unused_snp:
        hist = np.zeros(model.n_snp, dtype=np.int64)
        for c in out.classifiers:
            hist[c.snp_index] += 1
        flag = hist > 0
        remap = np.full(model.n_snp, -1, dtype=np.int32)
        remap[flag] = np.arange(flag.sum(), dtype=np.int32)
        out.snp_id = out.snp_id[flag]
        out.snp_position = out.snp_position[flag]
        out.snp_allele = out.snp_allele[flag]
        if out.snp_allele_freq is not None:
            out.snp_allele_freq = out.snp_allele_freq[flag]
        for c in out.classifiers:
            c.snp_index = remap[c.snp_index]

    if anonymize:
        out.sample_id = None
        for c in out.classifiers:
            c.bootstrap_count = None
    return out


def model_files(patterns: Sequence[str], ignore_missing: bool = True) -> AttrBagModel:
    """Load and combine classifier sets from multiple saved model files."""
    files: list[str] = []
    for p in patterns:
        hits = sorted(_glob.glob(p))
        if not hits and not ignore_missing:
            raise FileNotFoundError(p)
        files.extend(hits if hits else ([p] if not ignore_missing else []))
    if not files:
        raise ValueError("no model files found")
    model = AttrBagModel.load(files[0])
    for f in files[1:]:
        model = model.combine(AttrBagModel.load(f))
    return model


def model_to_robj(model: AttrBagModel):
    """Build the hlaAttrBagObj RObj tree (the exact schema hlaModelToObj
    emits, reference R/HIBAG.R:1041-1062 — consumed by R's
    hlaModelFromObj)."""
    from ..io.rdata import INTSXP, RObj, STRSXP, VECSXP, py_to_r, r_dataframe

    o = model.to_hibag_obj()
    cls_objs = []
    for c in o["classifiers"]:
        fields = {
            "samp.num": (None if c["samp.num"] is None else
                         RObj(INTSXP, np.asarray(c["samp.num"], np.int64))),
            "haplos": r_dataframe({
                "freq": np.asarray(c["haplos"]["freq"], np.float64),
                "hla": c["haplos"]["hla"],
                "haplo": c["haplos"]["haplo"],
            }),
            "snpidx": RObj(INTSXP, np.asarray(c["snpidx"], np.int64)),
            "outofbag.acc": float(c["outofbag.acc"]),
        }
        cls_objs.append(py_to_r(fields))
    top = {
        "n.samp": int(o["n.samp"]), "n.snp": int(o["n.snp"]),
        "sample.id": (None if o["sample.id"] is None else o["sample.id"]),
        "snp.id": o["snp.id"],
        "snp.position": RObj(INTSXP, np.asarray(o["snp.position"],
                                                np.int64)),
        "snp.allele": o["snp.allele"],
        "snp.allele.freq": o["snp.allele.freq"],
        "hla.locus": o["hla.locus"],
        "hla.allele": o["hla.allele"],
        "hla.freq": o["hla.freq"],
        "assembly": o["assembly"],
        "classifiers": RObj(VECSXP, cls_objs),
        "matching": (None if model.matching is None
                     else np.asarray(model.matching, np.float64)),
        "appendix": (model.appendix or None),
    }
    robj = py_to_r(top)
    robj.attrs["class"] = RObj(STRSXP, ["hlaAttrBagObj"])
    return robj


def save_rdata(models, path: str, name: Optional[str] = None) -> None:
    """Export to a .RData file loadable by R HIBAG.

    A single AttrBagModel saves as one hlaAttrBagObj (default object name
    "mobj" — load() then hlaModelFromObj(mobj) in R); a {locus: model}
    dict saves as a named list like the package's bundled ModelList.RData
    (default name "modellist"). Mirrors hlaModelToObj + save()
    (reference R/HIBAG.R:1041, R/DataUtilities.R:2083-2096)."""
    from ..io.rdata import write_rdata

    if isinstance(models, AttrBagModel):
        write_rdata(path, {name or "mobj": model_to_robj(models)})
    else:
        ml = {str(k): model_to_robj(v) for k, v in models.items()}
        from ..io.rdata import py_to_r
        write_rdata(path, {name or "modellist": py_to_r(ml)})


def out_of_bag(model: AttrBagModel, hla_table, geno_data,
               call_threshold: float = float("nan"), verbose: bool = False,
               device="cuda"):
    """Out-of-bag evaluation: each classifier predicts only its own OOB
    samples; overall/confusion/detail tables are averaged over classifiers
    (hlaOutOfBag). The predictions run on `device` ("cuda" by default,
    which raises without a card; "cpu" runs the plain versions)."""
    from ..eval.compare import compare_alleles
    from .predict import predict

    if model.sample_id is None:
        raise ValueError("model has no sample IDs (published/anonymized?)")
    geno_pos = {s: i for i, s in enumerate(geno_data.sample_id)}
    cols = np.array([geno_pos[s] for s in model.sample_id])

    gidx = {s: j for j, s in enumerate(geno_data.snp_id)}
    sel = np.array([gidx[s] for s in model.snp_id])
    geno_sel_rows = geno_data.genotype[sel]          # [P_model, N_geno]

    sum_overall: dict = {}
    sum_conf = None
    sum_detail: dict = {}
    n_detail: dict = {}
    detail_head = None
    n = 0
    nm2 = ("call.rate", "accuracy", "sensitivity", "specificity", "ppv", "npv")

    for i, c in enumerate(model.classifiers):
        if c.bootstrap_count is None:
            raise ValueError("classifier has no bootstrap counts")
        sub = AttrBagModel(**{**model.__dict__})
        sub.classifiers = [c]
        oob_mask = c.bootstrap_count == 0
        codes = geno_sel_rows[:, cols[oob_mask]].T
        res = predict(sub, codes.astype(np.uint8), device=device)
        res.sample_id = np.asarray(model.sample_id)[oob_mask]
        pam = compare_alleles(hla_table, res, allele_limit=model,
                              call_threshold=call_threshold)
        for k, v in pam.overall.items():
            sum_overall[k] = sum_overall.get(k, 0.0) + (v if np.isfinite(v) else 0.0)
        sum_conf = pam.confusion if sum_conf is None else sum_conf + pam.confusion
        if detail_head is None:
            detail_head = {k: pam.detail[k] for k in
                           ("allele", "valid.num", "valid.freq")}
        for k in nm2:
            v = np.asarray(pam.detail[k], dtype=float)
            ok = np.isfinite(v)
            n_detail[k] = n_detail.get(k, 0) + ok.astype(int)
            sum_detail[k] = sum_detail.get(k, 0.0) + np.where(ok, v, 0.0)
        n += 1
        if verbose:
            print(f"passing the {i + 1}/{model.n_classifiers} classifiers")

    overall = {k: v / n for k, v in sum_overall.items()}
    confusion = sum_conf / n
    detail = dict(detail_head)
    for k in nm2:
        with np.errstate(invalid="ignore", divide="ignore"):
            detail[k] = sum_detail[k] / n_detail[k]
    return {"overall": overall, "confusion": confusion, "detail": detail}


def pred_merge(results: Sequence[PredictionResult], weight=None,
               equivalence: Optional[dict] = None, use_matching: bool = True,
               max_resolution: str = "", rm_suffix: bool = False,
               ret_dosage: bool = True,
               ret_postprob: bool = False) -> PredictionResult:
    """Merge predictions from multiple models over the same samples
    (hlaPredMerge): per-sample weighted average of posterior-probability
    vectors mapped into the union allele space, optionally weighted by each
    model's matching proportion."""
    if not results:
        raise ValueError("no predictions to merge")
    for r in results:
        if r.postprob is None:
            raise ValueError("predictions must carry postprob "
                             "(predict(..., with_prob=True))")
        if not np.array_equal(r.sample_id, results[0].sample_id):
            raise ValueError("sample IDs must be identical")
    n_samp = len(results[0].sample_id)

    if weight is None:
        weight = np.full(len(results), 1.0 / len(results))
    else:
        weight = np.asarray(weight, dtype=float)
        if (weight < 0).any() or not np.isfinite(weight).all():
            raise ValueError("invalid weight")
        weight = weight / weight.sum()

    def rename(a: str) -> str:
        import re
        if equivalence and a in equivalence:
            a = equivalence[a]
        if max_resolution not in ("", "full"):
            a = allele_digit(a, max_resolution, rm_suffix=rm_suffix)
        elif rm_suffix:
            a = re.sub(r"\D+$", "", a)
        return a

    union: list[str] = []
    for r in results:
        union.extend(rename(a) for a in r.hla_alleles)
    alleles = unique_alleles(union)
    A = len(alleles)
    aidx = {a: i for i, a in enumerate(alleles)}
    iu, ju = np.triu_indices(A)
    pair_idx = {(int(i), int(j)): k for k, (i, j) in enumerate(zip(iu, ju))}

    prob = np.zeros((len(iu), n_samp))
    matching = np.zeros(n_samp)
    has_matching = use_matching and all(r.matching is not None for r in results)
    for w, r in zip(weight, results):
        src = [rename(a) for a in r.hla_alleles]
        Ai = len(src)
        si, sj = np.triu_indices(Ai)
        rows = np.array([pair_idx[tuple(sorted((aidx[src[i]], aidx[src[j]])))]
                         for i, j in zip(si, sj)])
        p = np.asarray(r.postprob, dtype=float)
        if has_matching:
            p = p * np.asarray(r.matching)[None, :]
        np.add.at(prob, rows, p * w)
        if has_matching:
            matching += w * np.asarray(r.matching)
    colsum = prob.sum(0)
    with np.errstate(invalid="ignore", divide="ignore"):
        prob = prob / colsum[None, :]

    best = prob.argmax(0)
    maxp = prob[best, np.arange(n_samp)]
    al = np.asarray(alleles, dtype=object)
    a1 = al[iu[best]]
    a2 = al[ju[best]]

    dosage = None
    if ret_dosage:
        dosage = np.zeros((A, n_samp))
        for k, (i, j) in enumerate(zip(iu, ju)):
            dosage[i] += prob[k]
            dosage[j] += prob[k]
    return PredictionResult(
        sample_id=results[0].sample_id, allele1=a1, allele2=a2, prob=maxp,
        matching=matching if has_matching else np.full(n_samp, np.nan),
        dosage=dosage, postprob=prob if ret_postprob else None,
        hla_alleles=list(alleles), locus=results[0].locus)
