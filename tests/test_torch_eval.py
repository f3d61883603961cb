"""The port's evaluation surface (hibag_tpu_torch.eval: report, assoc,
plots, compare) held against hibag_tpu's on the same seeded inputs: report
text and association tables equal, the plots drawn without error.

The cases of tests/test_assoc.py and tests/test_eval.py that need no
bundled fixture run here over both packages (the `pkg` parameter)."""

import importlib
import os

import numpy as np
import pytest

import hibag_tpu
import hibag_tpu_torch

PKGS = ("hibag_tpu", "hibag_tpu_torch")


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _cohort(pkg):
    """tests/test_assoc.py's cohort: 400 samples, 02:01 doubles the odds."""
    rng = np.random.default_rng(1)
    n = 400
    alleles = ["01:01", "02:01", "03:01", "24:02"]
    a1 = rng.choice(alleles, n, p=[0.4, 0.3, 0.2, 0.1])
    a2 = rng.choice(alleles, n, p=[0.4, 0.3, 0.2, 0.1])
    carrier = (a1 == "02:01") | (a2 == "02:01")
    logit = -1.0 + 1.2 * carrier
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)
    t = _mod(pkg, "data.allele").HLATypeTable.from_alleles(
        [f"s{i}" for i in range(n)], a1, a2, locus="A")
    t.prob = rng.uniform(0.3, 1.0, n)
    return t, y, carrier


def _same(a, b, path=""):
    """Exact equality of nested results (NaN equal to NaN), float
    statistics allowed rtol 1e-12."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) and a.dtype == object:
        assert list(a.ravel()) == list(np.asarray(b).ravel()), path
    elif isinstance(a, (float, np.floating, np.ndarray)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=path)
    else:
        assert a == b, path


# --- hibag_tpu's association cases, for both packages -------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_binary_dominant(pkg):
    assoc_test = _mod(pkg, "eval.assoc").assoc_test
    t, y, _ = _cohort(pkg)
    res = assoc_test(t, y, model="dominant", show_or=True)
    assert res["binary"]
    row = next(r for r in res["table"] if r["allele"] == "02:01")
    assert row["chisq.p"] < 0.01 and row["fisher.p"] < 0.01
    assert row["h_OR.est"] > 1.5 and row["h.pval"] < 0.01
    null = next(r for r in res["table"] if r["allele"] == "01:01")
    assert null["chisq.p"] > 1e-4


@pytest.mark.parametrize("pkg", PKGS)
def test_quantitative_additive(pkg):
    assoc_test = _mod(pkg, "eval.assoc").assoc_test
    t, _, _ = _cohort(pkg)
    n1 = (t.allele1 == "03:01").astype(int) + (t.allele2 == "03:01").astype(int)
    q = 1.0 * n1 + np.random.default_rng(2).normal(0, 1, t.n_samp)
    row = next(r for r in assoc_test(t, q, model="additive")["table"]
               if r["allele"] == "03:01")
    assert row["ttest.p"] < 1e-4 and abs(row["h.est"] - 1.0) < 0.4


@pytest.mark.parametrize("pkg", PKGS)
def test_genotype_model(pkg):
    t, y, _ = _cohort(pkg)
    row = _mod(pkg, "eval.assoc").assoc_test(t, y, model="genotype")[
        "table"][0]
    assert row["[-/-]"] + row["[-/h]"] + row["[h/h]"] == t.n_samp


@pytest.mark.parametrize("pkg", PKGS)
def test_glm_fit_logistic_recovers_beta(pkg):
    rng = np.random.default_rng(0)
    n = 2000
    x = rng.normal(size=n)
    X = np.column_stack([np.ones(n), x])
    y = (rng.random(n) < 1 / (1 + np.exp(-(0.5 + 1.5 * x)))).astype(float)
    beta, _, ok = _mod(pkg, "eval.assoc").glm_fit(X, y, "binomial")
    assert ok and abs(beta[1] - 1.5) < 0.2


@pytest.mark.parametrize("pkg", PKGS)
def test_format_assoc(pkg):
    assoc = _mod(pkg, "eval.assoc")
    t, y, _ = _cohort(pkg)
    s = assoc.format_assoc(assoc.assoc_test(t, y, model="dominant"))
    assert "chisq.p" in s.splitlines()[0] and "*" in s


# --- the port against hibag_tpu ---------------------------------------------

@pytest.mark.parametrize("model", ["dominant", "additive", "recessive",
                                   "genotype"])
@pytest.mark.parametrize("trait", ["binary", "quantitative"])
@pytest.mark.parametrize("opts", [
    {}, {"show_or": True}, {"use_prob": True},
    {"prob_threshold": 0.5, "covariates": "age"}])
def test_assoc_test_matches(model, trait, opts):
    """assoc_test and format_assoc: equal tables and equal text."""
    out = []
    for pkg in PKGS:
        assoc = _mod(pkg, "eval.assoc")
        t, y, _ = _cohort(pkg)
        if trait == "quantitative":
            y = y + np.random.default_rng(6).normal(0, 1, t.n_samp)
        kw = dict(opts)
        if kw.get("covariates"):
            kw["covariates"] = {
                "age": np.random.default_rng(3).normal(50, 10, t.n_samp)}
        res = assoc.assoc_test(t, y, model=model, **kw)
        out.append((res, assoc.format_assoc(res),
                    assoc.format_assoc(res, show_all=False)))
    _same(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


def test_glm_fit_matches():
    rng = np.random.default_rng(7)
    X = np.column_stack([np.ones(300), rng.normal(size=(300, 2))])
    yb = (rng.random(300) < 0.4).astype(float)
    yq = X @ [0.5, 1.0, -2.0] + rng.normal(size=300)
    w = rng.uniform(0.5, 1.0, 300)
    for y, fam in ((yb, "binomial"), (yq, "gaussian")):
        got = [_mod(pkg, "eval.assoc").glm_fit(X, y, fam, weights=w)
               for pkg in PKGS]
        _same(list(got[0]), list(got[1]))


def _aa_table():
    """hibag_tpu's AASeqTable of 200 samples over 12 residues ('*' is
    unknown), with posterior probabilities."""
    from hibag_tpu.seq.aa import AASeqTable
    rng = np.random.default_rng(8)
    pool = ["MAVMAPRTLLLL", "MAVMPPRTLVLL", "MAVMAPRTLLL*", "MRVMAPRTLLLA"]
    a1 = np.array(rng.choice(pool, 200), dtype=object)
    a2 = np.array(rng.choice(pool, 200), dtype=object)
    a1[3] = None
    return AASeqTable(locus="A", sample_id=np.arange(200).astype(str),
                      allele1=a1, allele2=a2, start_position=1,
                      reference=pool[0], prob=rng.uniform(0.2, 1.0, 200))


@pytest.mark.parametrize("trait", ["binary", "quantitative"])
def test_aa_assoc_test_matches(trait):
    """aa_assoc_test, also through hlaAssocTest's dispatch: equal rows."""
    aa = _aa_table()
    rng = np.random.default_rng(9)
    y = rng.integers(0, 2, 200) if trait == "binary" else rng.normal(
        size=200)
    rows = [_mod(pkg, "eval.assoc").aa_assoc_test(aa, y, prob_threshold=0.3)
            for pkg in PKGS]
    _same(rows[0], rows[1])
    assert len(rows[1]) >= 3
    _same(hibag_tpu.hlaAssocTest(aa, y), hibag_tpu_torch.hlaAssocTest(aa, y))
    t, yy, _ = _cohort("hibag_tpu_torch")
    _same(hibag_tpu_torch.hlaAssocTest(t, yy),
          hibag_tpu.hlaAssocTest(_cohort("hibag_tpu")[0], yy))


def _tables(pkg, seed=0, n=60):
    """(truth, prediction with prob, training table) over 8 alleles."""
    rng = np.random.default_rng(seed)
    names = [f"{i:02d}:01" for i in range(1, 9)]
    HLATypeTable = _mod(pkg, "data.allele").HLATypeTable
    ids = [f"s{i}" for i in range(n)]
    t1, t2 = rng.choice(names, n), rng.choice(names, n)
    p1, p2 = t1.copy(), t2.copy()
    wrong = rng.random(n) < 0.2
    p1[wrong] = rng.choice(names, int(wrong.sum()))
    truth = HLATypeTable.from_alleles(ids, t1, t2, locus="A")
    pred = HLATypeTable.from_alleles(ids, p1, p2, locus="A")
    pred.prob = rng.uniform(0.2, 1.0, n)
    return truth, pred


@pytest.mark.parametrize("fmt", ["txt", "md", "markdown", "tex", "html"])
@pytest.mark.parametrize("threshold", [float("nan"), 0.5])
def test_report_matches(fmt, threshold):
    """report of compare_alleles' result: equal text in every format."""
    text = []
    for pkg in PKGS:
        truth, pred = _tables(pkg)
        res = _mod(pkg, "eval.compare").compare_alleles(
            truth, pred, call_threshold=threshold)
        text.append(_mod(pkg, "eval.report").report(res, fmt=fmt))
    assert text[0] == text[1]
    assert "accuracy" in text[1].lower()


# --- hibag_tpu's compare cases, for both packages ----------------------------

def _t(pkg, ids, a1, a2):
    return _mod(pkg, "data.allele").HLATypeTable.from_alleles(ids, a1, a2,
                                                              locus="A")


@pytest.mark.parametrize("pkg", PKGS)
def test_compare_cases(pkg):
    """tests/test_eval.py's cases: perfect, half accuracy, call threshold,
    4-digit truncation, individual output."""
    compare = _mod(pkg, "eval.compare").compare_alleles
    ids = [f"s{i}" for i in range(4)]
    t = _t(pkg, ids, ["01:01", "02:01", "01:01", "03:01"],
           ["02:01", "02:01", "03:01", "03:01"])
    r = compare(t, t)
    assert r.overall["acc.ind"] == r.overall["acc.haplo"] == 1.0
    ids = ["s0", "s1"]
    t = _t(pkg, ids, ["01:01", "01:01"], ["02:01", "02:01"])
    p = _t(pkg, ids, ["01:01", "03:01"], ["03:01", "02:01"])
    r = compare(t, p)
    assert r.overall["acc.haplo"] == 0.5 and r.overall["acc.ind"] == 0.0
    np.testing.assert_allclose(r.confusion.sum(), 4.0)
    p = _t(pkg, ids, ["01:01", "01:01"], ["02:01", "02:01"])
    p.prob = np.array([0.9, 0.3])
    r = compare(t, p, call_threshold=0.5)
    assert r.overall["n.call"] == 1 and r.overall["call.rate"] == 0.5
    t = _t(pkg, ["s0"], ["01:01:01"], ["02:01:05"])
    p = _t(pkg, ["s0"], ["01:01:02"], ["02:01:88"])
    assert compare(t, p).overall["acc.haplo"] == 0.0
    assert compare(t, p, max_resolution="4-digit").overall["acc.haplo"] == 1.0
    t = _t(pkg, ids, ["01:01", "01:01"], ["02:01", "02:01"])
    p = _t(pkg, ids, ["01:01", "03:01"], ["02:01", "03:01"])
    r = compare(t, p, output_individual=True)
    np.testing.assert_allclose(r.individual["accuracy"], [1.0, 0.0])


@pytest.mark.parametrize("pkg", PKGS)
def test_confusion_em_redistribution(pkg):
    out = _mod(pkg, "eval.compare").confusion_em(2, np.zeros((3, 2)),
                                                 [(0, 1, 2, 2)])
    np.testing.assert_allclose(out[2], [1.0, 1.0])
    np.testing.assert_allclose(out.sum(), 2.0)


# --- plots ------------------------------------------------------------------

def test_plots_draw(tmp_path):
    """Every plot_* function and hlaReportPlot's figures draw (matplotlib,
    Agg) from the port's objects, and save to a file."""
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,
                                                 synthetic_model)
    model, pool = synthetic_model(2, n_classifiers=6, n_snp=120,
                                  n_alleles=6)
    model.matching = np.linspace(1e-4, 0.5, 20)
    geno, t1, t2 = synthetic_cohort(model, pool, 40, 3)
    pred = hibag_tpu_torch.predict(model, geno, device="cpu")
    truth = hibag_tpu_torch.HLATypeTable.from_alleles(geno.sample_id, t1, t2,
                                                      locus="A")
    r2 = hibag_tpu_torch.ld_matrix(geno.subset(snp_mask=np.arange(15)))
    axes = [
        hibag_tpu_torch.plot_matching(pred, model),
        hibag_tpu_torch.plot_call_rate(pred, truth, n_points=5),
        hibag_tpu_torch.plot_call_threshold(pred, truth, n_points=5),
        hibag_tpu_torch.plot_model(model),
        hibag_tpu_torch.plot_ld_heatmap(r2),
        hibag_tpu_torch.hlaReportPlot(pred, truth, model, fig="matching"),
        hibag_tpu_torch.hlaReportPlot(pred, truth, fig="call.rate",
                                      n_points=4),
        hibag_tpu_torch.hlaReportPlot(pred, truth, fig="call.threshold",
                                      n_points=4),
    ]
    assert all(ax.figure is not None for ax in axes)
    out = tmp_path / "m.png"
    hibag_tpu_torch.plot_model(model, out_fn=str(out))
    assert out.stat().st_size > 0
    with pytest.raises(ValueError):
        hibag_tpu_torch.hlaReportPlot(pred, truth, fig="nope")
    plt.close("all")
