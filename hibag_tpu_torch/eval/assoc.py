"""Association tests between HLA alleles and phenotypes.

Equivalent of hlaAssocTest.hlaAlleleClass (reference R/Association.R:82-448):
per-allele genotype coding (dominant/additive/recessive/genotype),
chi-square + Fisher tests for binary traits, Welch t-test / one-way ANOVA
for quantitative traits, and GLM (logistic or linear, optional
posterior-probability weights) with Wald confidence intervals and optional
odds ratios. Regression is an in-house IRLS implementation (no external GLM
dependency).

The port's copy of hibag_tpu/eval/assoc.py, so that the port imports nothing
of that package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import stats

from ..data.allele import unique_alleles

MODELS = ("dominant", "additive", "recessive", "genotype")


def _code(a1, a2, allele: str, model: str):
    """Per-sample coding for one allele under the genetic model."""
    c1 = (a1 == allele).astype(int)
    c2 = (a2 == allele).astype(int)
    n = c1 + c2
    if model == "dominant":
        return (n > 0).astype(int)
    if model == "recessive":
        return (n == 2).astype(int)
    return n  # additive / genotype


def glm_fit(X: np.ndarray, y: np.ndarray, family: str = "gaussian",
            weights: Optional[np.ndarray] = None, max_iter: int = 50,
            tol: float = 1e-9):
    """GLM via IRLS. Returns (beta, cov, converged)."""
    n, p = X.shape
    w0 = np.ones(n) if weights is None else np.asarray(weights, dtype=float)
    if family == "gaussian":
        XtWX = X.T @ (w0[:, None] * X)
        beta = np.linalg.solve(XtWX, X.T @ (w0 * y))
        resid = y - X @ beta
        dof = max(n - p, 1)
        sigma2 = (w0 * resid ** 2).sum() / dof
        cov = np.linalg.inv(XtWX) * sigma2
        return beta, cov, True
    if family != "binomial":
        raise ValueError(f"unsupported family {family!r}")
    beta = np.zeros(p)
    for _ in range(max_iter):
        eta = X @ beta
        mu = 1.0 / (1.0 + np.exp(-eta))
        mu = np.clip(mu, 1e-10, 1 - 1e-10)
        Wd = w0 * mu * (1 - mu)
        z = eta + (y - mu) / (mu * (1 - mu))
        XtWX = X.T @ (Wd[:, None] * X)
        try:
            beta_new = np.linalg.solve(XtWX, X.T @ (Wd * z))
        except np.linalg.LinAlgError:
            return beta, np.full((p, p), np.nan), False
        if np.max(np.abs(beta_new - beta)) < tol:
            beta = beta_new
            break
        beta = beta_new
    eta = X @ beta
    mu = np.clip(1.0 / (1.0 + np.exp(-eta)), 1e-10, 1 - 1e-10)
    Wd = w0 * mu * (1 - mu)
    try:
        cov = np.linalg.inv(X.T @ (Wd[:, None] * X))
    except np.linalg.LinAlgError:
        cov = np.full((p, p), np.nan)
    return beta, cov, True


def assoc_test(hla_table, y, covariates: Optional[dict] = None,
               model: str = "dominant", prob_threshold: float = float("nan"),
               use_prob: bool = False, show_or: bool = False,
               with_regression: bool = True) -> dict:
    """Per-allele association table.

    hla_table: HLATypeTable (or PredictionResult-like with allele1/2, prob);
    y: phenotype vector (binary 0/1 or factor-like → logistic; numeric →
    linear); covariates: optional {name: array} additional regressors.

    Returns {allele: {counts..., tests..., regression...}} plus a
    column-oriented table under key "table".
    """
    if model not in MODELS:
        raise ValueError(f"model must be one of {MODELS}")
    a1 = np.asarray(hla_table.allele1, dtype=object)
    a2 = np.asarray(hla_table.allele2, dtype=object)
    y = np.asarray(y)
    if len(y) != len(a1):
        raise ValueError(f"phenotype length {len(y)} != number of typed "
                         f"samples {len(a1)}")
    prob = getattr(hla_table, "prob", None)
    if np.isfinite(prob_threshold):
        if prob is None:
            raise ValueError("prob_threshold requires posterior probabilities")
        keep = np.asarray(prob) >= prob_threshold
        a1, a2, y = a1[keep], a2[keep], y[keep]
        prob = np.asarray(prob)[keep]
        if covariates:
            covariates = {k: np.asarray(v)[keep] for k, v in covariates.items()}

    # binary if two unique non-nan values in {0,1} or category-like
    yv = y
    uniq = set(np.unique(y[~_isnan(y)]).tolist())
    binary = uniq <= {0, 1, 0.0, 1.0, False, True} and len(uniq) == 2
    if binary:
        yv = y.astype(float)

    alleles = unique_alleles(np.concatenate([a1, a2]))
    out: dict = {"model": model, "alleles": alleles, "binary": binary}
    rows = []
    for s in alleles:
        row: dict = {"allele": s}
        n1 = (a1 == s).astype(int) + (a2 == s).astype(int)
        if model == "dominant":
            grp = (n1 > 0).astype(int)
            labels = ["[-/-]", "[-/h,h/h]"]
            groups = [0, 1]
        elif model == "recessive":
            grp = (n1 == 2).astype(int)
            labels = ["[-/-,-/h]", "[h/h]"]
            groups = [0, 1]
        elif model == "additive":
            grp = np.concatenate([(a1 == s).astype(int), (a2 == s).astype(int)])
            labels = ["[-]", "[h]"]
            groups = [0, 1]
        else:
            grp = n1
            labels = ["[-/-]", "[-/h]", "[h/h]"]
            groups = [0, 1, 2]
        yy = np.concatenate([yv, yv]) if model == "additive" else yv
        for g, lab in zip(groups, labels):
            row[lab] = int((grp == g).sum())
            if binary:
                sel = grp == g
                row["%." + lab] = (round(float(np.nanmean(yy[sel]) * 100), 1)
                                   if sel.any() else float("nan"))

        if binary:
            tab = np.zeros((len(groups), 2))
            for gi, g in enumerate(groups):
                for ci, c in enumerate((0.0, 1.0)):
                    tab[gi, ci] = ((grp == g) & (yy == c)).sum()
            tab = tab[tab.sum(1) > 0][:, tab.sum(0) > 0] if tab.size else tab
            try:
                chi2, p, _, _ = stats.chi2_contingency(tab, correction=True)
                row["chisq.st"], row["chisq.p"] = float(chi2), float(p)
            except Exception:
                row["chisq.st"] = row["chisq.p"] = float("nan")
            try:
                if tab.shape == (2, 2):
                    _, fp = stats.fisher_exact(tab)
                    row["fisher.p"] = float(fp)
                else:
                    row["fisher.p"] = float("nan")
            except Exception:
                row["fisher.p"] = float("nan")
        else:
            means = [float(np.nanmean(yy[grp == g])) if (grp == g).any()
                     else float("nan") for g in groups]
            for lab, mval in zip(labels, means):
                row["avg." + lab] = mval
            try:
                if len(groups) == 2:
                    g0, g1 = yy[grp == 0], yy[grp == 1]
                    _, p = stats.ttest_ind(g0, g1, equal_var=False)
                    row["ttest.p"] = float(p)
                else:
                    sets = [yy[grp == g] for g in groups if (grp == g).sum() > 0]
                    _, p = stats.f_oneway(*sets)
                    row["anova.p"] = float(p)
            except Exception:
                row["ttest.p" if len(groups) == 2 else "anova.p"] = float("nan")

        if with_regression:
            h = _code(a1, a2, s, model)
            cols = [np.ones(len(yv))]
            names = ["(Intercept)"]
            if model == "genotype":
                cols += [(h == 1).astype(float), (h == 2).astype(float)]
                names += ["h1", "h2"]
            else:
                cols.append(h.astype(float))
                names.append("h")
            for cname, cvals in (covariates or {}).items():
                cols.append(np.asarray(cvals, dtype=float))
                names.append(cname)
            X = np.column_stack(cols)
            ok = np.isfinite(X).all(1) & np.isfinite(yv.astype(float))
            w = None
            if use_prob:
                if prob is None:
                    raise ValueError("use_prob requires posterior probabilities")
                w = np.asarray(prob, dtype=float)[ok]
            fam = "binomial" if binary else "gaussian"
            try:
                beta, cov, okfit = glm_fit(X[ok], yv[ok].astype(float), fam, w)
                se = np.sqrt(np.diag(cov))
                zvals = beta / se
                if fam == "binomial":
                    pvals = 2 * stats.norm.sf(np.abs(zvals))
                else:
                    dof = max(ok.sum() - X.shape[1], 1)
                    pvals = 2 * stats.t.sf(np.abs(zvals), dof)
                ci_lo = beta - 1.959963984540054 * se
                ci_hi = beta + 1.959963984540054 * se
                for j, nm in enumerate(names):
                    if nm == "(Intercept)":
                        continue
                    est, lo, hi = beta[j], ci_lo[j], ci_hi[j]
                    if show_or and binary and nm.startswith("h"):
                        with np.errstate(over="ignore"):
                            est, lo, hi = np.exp([est, lo, hi])
                        nm = nm + "_OR"
                    row[f"{nm}.est"] = float(est)
                    row[f"{nm}.2.5%"] = float(lo)
                    row[f"{nm}.97.5%"] = float(hi)
                    row[f"{nm.removesuffix('_OR')}.pval"] = float(pvals[j])
            except Exception:
                pass
        rows.append(row)

    out["table"] = rows
    return out


def _isnan(y):
    try:
        return np.isnan(y.astype(float))
    except (TypeError, ValueError):
        return np.zeros(len(y), dtype=bool)


def format_assoc(result, show_all: bool = True) -> str:
    """Render an assoc_test / aa_assoc_test result as the reference's
    significance-starred table (.assoc_show, R/Association.R:40-73):
    p-values < 0.001 print as '<0.001*', p in [0.001, 0.05] get a '*',
    non-finite print as '.'; significant rows are listed first."""
    rows = result["table"] if isinstance(result, dict) else list(result)
    if not rows:
        return "(no rows)"
    cols = []
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)
    pcols = [c for c in cols if c.endswith((".p", ".pval"))]

    def fmt(r, c):
        v = r.get(c)
        if v is None:
            return "."
        if c in pcols:
            if not (isinstance(v, (int, float)) and np.isfinite(v)):
                return "."
            if v < 0.001:
                return "<0.001*"
            s = f"{v:.3f}"
            return s + "*" if v <= 0.05 else s
        if isinstance(v, float):
            return "." if not np.isfinite(v) else f"{v:.4g}"
        return str(v)

    def significant(r):
        return any(isinstance(r.get(c), (int, float)) and np.isfinite(r[c])
                   and r[c] <= 0.05 for c in pcols)

    sig = [r for r in rows if significant(r)]
    rest = [r for r in rows if not significant(r)]
    ordered = sig + ([{"__sep__": True}] if sig and rest and show_all else []) \
        + (rest if show_all else [])
    table = [[fmt(r, c) if "__sep__" not in r else "-----" for c in cols]
             for r in ordered]
    widths = [max(len(c), *(len(t[j]) for t in table)) if table else len(c)
              for j, c in enumerate(cols)]
    out = ["  ".join(c.rjust(w) for c, w in zip(cols, widths))]
    for t in table:
        out.append("  ".join(x.rjust(w) for x, w in zip(t, widths)))
    return "\n".join(out)


def aa_assoc_test(aa_table, y, covariates: Optional[dict] = None,
                  prob_threshold: float = float("nan"),
                  use_prob: bool = False) -> list:
    """Per-amino-acid-position association (hlaAssocTest.hlaAASeqClass,
    reference R/Association.R:457-726).

    For each position: the residues of both chromosomes (outcome doubled)
    form a residue × outcome contingency table tested by chi-square (Fisher
    for 2×2); '*' (unknown) residues are dropped. Additionally a per-residue
    dominant-coded logistic/linear regression is fit.

    Returns a list of row dicts (one per polymorphic position).
    """
    a1 = np.asarray(aa_table.allele1, dtype=object)
    a2 = np.asarray(aa_table.allele2, dtype=object)
    y = np.asarray(y)
    prob = getattr(aa_table, "prob", None)
    if np.isfinite(prob_threshold):
        if prob is None:
            raise ValueError("prob_threshold requires posterior probabilities")
        keep = np.asarray(prob) >= prob_threshold
        a1, a2, y = a1[keep], a2[keep], y[keep]
        prob = np.asarray(prob)[keep]
        if covariates:
            covariates = {k: np.asarray(v)[keep] for k, v in covariates.items()}

    ok = np.array([s1 is not None and s2 is not None
                   for s1, s2 in zip(a1, a2)])
    a1, a2, yv = a1[ok], a2[ok], y[ok]
    if prob is not None:
        prob = np.asarray(prob)[ok]
    if covariates:
        covariates = {k: np.asarray(v)[ok] for k, v in covariates.items()}
    if len(a1) == 0:
        return []
    n = max(max(len(s) for s in a1), max(len(s) for s in a2))
    uniq = set(np.unique(yv[~_isnan(yv)]).tolist())
    binary = uniq <= {0, 1, 0.0, 1.0, False, True} and len(uniq) == 2
    y2 = np.concatenate([yv, yv]).astype(float)

    rows = []
    for j in range(n):
        res = np.array([(s[j] if j < len(s) else "*")
                        for s in np.concatenate([a1, a2])], dtype="U1")
        valid = res != "*"
        r, yy = res[valid], y2[valid]
        levels = sorted(set(r))
        if len(levels) < 2:
            continue
        pos = j + 1 - aa_table.start_position + 1
        row: dict = {"pos": int(pos),
                     "residues": "".join(levels)}
        if binary:
            tab = np.array([[((r == lv) & (yy == c)).sum()
                             for c in (0.0, 1.0)] for lv in levels])
            tab = tab[tab.sum(1) > 0][:, tab.sum(0) > 0]
            try:
                if tab.shape == (2, 2):
                    _, p = stats.fisher_exact(tab)
                    row["fisher.p"] = float(p)
                chi2, cp, _, _ = stats.chi2_contingency(tab)
                row["chisq.p"] = float(cp)
            except Exception:
                pass
        else:
            try:
                groups = [yy[r == lv] for lv in levels if (r == lv).sum() > 1]
                if len(groups) >= 2:
                    _, p = stats.f_oneway(*groups)
                    row["anova.p"] = float(p)
            except Exception:
                pass
        # per-residue dominant regression on individuals
        for lv in levels:
            h = np.array([int((s1[j:j + 1] == lv) or (s2[j:j + 1] == lv))
                          for s1, s2 in zip(a1, a2)], dtype=float)
            if h.std() == 0:
                continue
            cols = [np.ones(len(h)), h]
            names = ["(Intercept)", "h"]
            for cname, cvals in (covariates or {}).items():
                cols.append(np.asarray(cvals, dtype=float))
                names.append(cname)
            X = np.column_stack(cols)
            okx = np.isfinite(X).all(1) & np.isfinite(yv.astype(float))
            w = prob[okx] if (use_prob and prob is not None) else None
            try:
                fam = "binomial" if binary else "gaussian"
                beta, cov, _ = glm_fit(X[okx], yv[okx].astype(float), fam, w)
                se = np.sqrt(np.diag(cov))
                z = beta[1] / se[1]
                p = 2 * stats.norm.sf(abs(z)) if fam == "binomial" else \
                    2 * stats.t.sf(abs(z), max(okx.sum() - X.shape[1], 1))
                row[f"{lv}.est"] = float(beta[1])
                row[f"{lv}.pval"] = float(p)
            except Exception:
                pass
        rows.append(row)
    return rows
