"""Accuracy report generation in text / markdown / LaTeX / HTML.

Equivalent of hlaReport (reference R/DataUtilities.R:2184-2427): renders a
CompareResult's overall numbers and per-allele detail table.

The port's copy of hibag_tpu/eval/report.py, so that the port imports nothing
of that package.
"""

from __future__ import annotations

import numpy as np


_COLUMNS = [
    ("allele", "Allele"),
    ("train.num", "Num. of training haplo."),
    ("train.freq", "Freq. of training haplo."),
    ("valid.num", "Num. of validation haplo."),
    ("valid.freq", "Freq. of validation haplo."),
    ("call.rate", "Call rate"),
    ("accuracy", "Accuracy"),
    ("sensitivity", "Sensitivity"),
    ("specificity", "Specificity"),
    ("ppv", "PPV"),
    ("npv", "NPV"),
    ("miscall", "Miscall"),
    ("miscall.prop", "Miscall prop."),
]


def _fmt(v):
    if v is None:
        return "--"
    if isinstance(v, (float, np.floating)):
        if not np.isfinite(v):
            return "--"
        return f"{v:.4g}"
    return str(v)


def _rows(result):
    detail = result.detail
    cols = [(k, h) for k, h in _COLUMNS if k in detail]
    header = [h for _, h in cols]
    rows = []
    n = len(detail["allele"])
    for i in range(n):
        rows.append([_fmt(np.asarray(detail[k], dtype=object)[i])
                     for k, _ in cols])
    return header, rows


def _overall_lines(result):
    o = result.overall
    return [
        f"Overall accuracy: {o['acc.haplo']:.1%} (per allele), "
        f"{o['acc.ind']:.1%} (per individual)",
        f"Call rate: {o['call.rate']:.1%} "
        f"({o['n.call']}/{o['total.num.ind']} individuals"
        + (f", threshold {o['call.threshold']}" if o.get("call.threshold")
           else "") + ")",
    ]


def report(result, fmt: str = "txt") -> str:
    """Render a CompareResult ('txt' | 'markdown' | 'tex' | 'html')."""
    header, rows = _rows(result)
    lines = _overall_lines(result)
    if fmt == "txt":
        widths = [max(len(h), *(len(r[j]) for r in rows)) if rows else len(h)
                  for j, h in enumerate(header)]
        out = lines + [""]
        out.append("  ".join(h.ljust(w) for h, w in zip(header, widths)))
        out.append("  ".join("-" * w for w in widths))
        for r in rows:
            out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
        return "\n".join(out)
    if fmt in ("markdown", "md"):
        out = [f"**{ln}**  " for ln in lines] + [""]
        out.append("| " + " | ".join(header) + " |")
        out.append("|" + "|".join("---" for _ in header) + "|")
        for r in rows:
            out.append("| " + " | ".join(r) + " |")
        return "\n".join(out)
    if fmt == "tex":
        out = ["\\begin{table}[t]", "\\centering",
               "\\caption{" + "; ".join(lines) + "}",
               "\\begin{tabular}{" + "l" * len(header) + "}", "\\hline",
               " & ".join(header) + " \\\\", "\\hline"]
        for r in rows:
            out.append(" & ".join(c.replace("%", "\\%") for c in r) + " \\\\")
        out += ["\\hline", "\\end{tabular}", "\\end{table}"]
        return "\n".join(out)
    if fmt == "html":
        out = ["<html><body>"] + [f"<p>{ln}</p>" for ln in lines]
        out.append("<table border=1><tr>"
                   + "".join(f"<th>{h}</th>" for h in header) + "</tr>")
        for r in rows:
            out.append("<tr>" + "".join(f"<td>{c}</td>" for c in r) + "</tr>")
        out += ["</table></body></html>"]
        return "\n".join(out)
    raise ValueError(f"unknown format {fmt!r}")
