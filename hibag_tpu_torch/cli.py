"""Command-line interface: `python -m hibag_tpu_torch <command>`
(counterpart of hibag_tpu/cli.py, with its commands, arguments and output
formats).

The reference exposes its functionality only as an R API; production
imputation pipelines typically wrap it in scripts. This CLI covers that
workflow natively:

  impute   impute HLA types for a cohort with a trained/published model
  train    train an attribute-bagging model from a genotype file + HLA table
  convert  convert genotype containers (BED/GDS/VCF) or HIBAG .RData models
           to this package's .npz formats
  summary  describe a model or genotype file
  report   accuracy report of predictions vs a truth table

Genotype inputs are auto-detected by extension: PLINK .bed (+.bim/.fam),
CoreArray .gds (SNP_ARRAY or flat SEQ_ARRAY), .vcf/.vcf.gz, or .npz written
by `convert`. Models load from .npz (native) or HIBAG .RData/.rds objects
(hlaAttrBagObj / model lists).

Every command takes --device (default "cuda"): `impute` predicts and
`train` trains there, through the CUDA kernels on a card; "cpu" runs their
plain PyTorch versions. With "cuda" and no card the command raises before
it reads a file, as hibag_tpu_torch.device.resolve_device does; nothing
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


# ---------------------------------------------------------------------------
# loading helpers
# ---------------------------------------------------------------------------

def load_geno(path: str, import_chr: str = "", assembly: str = "hg19"):
    """Genotype container by extension (BED/GDS/VCF/npz)."""
    from .data.geno import SNPGenoData
    p = path.lower()
    if p.endswith(".bed"):
        from .io.bed import read_bed
        return read_bed(path, import_chr=import_chr, assembly=assembly)
    if p.endswith(".gds"):
        from .io.gds import read_gds
        return read_gds(path, import_chr=import_chr, assembly=assembly)
    if p.endswith((".vcf", ".vcf.gz")):
        from .io.vcf_in import read_vcf
        return read_vcf(path, assembly=assembly)
    if p.endswith(".npz"):
        z = np.load(path, allow_pickle=True)
        return SNPGenoData(
            genotype=z["genotype"],
            sample_id=z["sample_id"].astype(object),
            snp_id=z["snp_id"].astype(object),
            snp_position=z["snp_position"],
            snp_allele=z["snp_allele"].astype(object),
            assembly=str(z["assembly"]))
    raise SystemExit(f"unrecognized genotype file type: {path}")


def save_geno(geno, path: str) -> None:
    np.savez_compressed(
        path, genotype=geno.genotype, sample_id=geno.sample_id,
        snp_id=geno.snp_id, snp_position=geno.snp_position,
        snp_allele=geno.snp_allele, assembly=geno.assembly)


def load_model(path: str, locus: str | None = None):
    """Model from native .npz or HIBAG .RData/.rds (single hlaAttrBagObj or
    a named model list — pass --locus to pick an entry)."""
    from .models.model import AttrBagModel
    p = path.lower()
    if p.endswith(".npz"):
        return AttrBagModel.load(path)
    if p.endswith((".rdata", ".rda", ".rds")):
        from .io.rdata import read_rdata, read_rds, r_to_py
        if p.endswith(".rds"):
            objs = {"model": read_rds(path)}
        else:
            objs = read_rdata(path)
        for obj in objs.values():
            d = r_to_py(obj)
            if not isinstance(d, dict):
                continue
            if "classifiers" in d:        # a single hlaAttrBagObj
                return AttrBagModel.from_hibag_obj(d, locus=locus)
            # a model list keyed by locus
            if locus is not None and locus in d:
                return AttrBagModel.from_hibag_obj(d[locus], locus=locus)
            for k, v in d.items():
                if isinstance(v, dict) and "classifiers" in v:
                    if locus is None:
                        return AttrBagModel.from_hibag_obj(v, locus=k)
        raise SystemExit(
            f"no hlaAttrBagObj found in {path}"
            + ("" if locus is None else f" for locus {locus!r}"))
    raise SystemExit(f"unrecognized model file type: {path}")


def load_hla_table(path: str, locus: str):
    """HLA truth/training table: TSV with sample.id + <locus>.1/<locus>.2
    (the bundled HLA_Type_Table layout) or allele1/allele2 columns; .RData
    containing such a table also works."""
    from .data.allele import HLATypeTable
    p = path.lower()
    if p.endswith((".rdata", ".rda")):
        from .io.rdata import read_rdata, r_to_py
        objs = read_rdata(path)
        tab = r_to_py(next(iter(objs.values())))
    else:
        import csv
        with open(path) as f:
            sniff = csv.Sniffer().sniff(f.read(4096), delimiters="\t, ;")
            f.seek(0)
            rows = list(csv.DictReader(f, dialect=sniff))
        tab = {k: np.array([r[k] for r in rows], dtype=object)
               for k in rows[0]}
    sid_key = "sample.id" if "sample.id" in tab else "sample_id"
    for k1, k2 in ((f"{locus}.1", f"{locus}.2"), ("allele1", "allele2"),
                   ("allele.1", "allele.2")):
        if k1 in tab:
            a1, a2 = tab[k1], tab[k2]
            break
    else:
        raise SystemExit(
            f"no allele columns for locus {locus!r} in {path} "
            f"(have: {sorted(tab)})")
    return HLATypeTable.from_alleles(tab[sid_key], a1, a2, locus=locus,
                                     assembly="hg19")


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------

def cmd_impute(a) -> int:
    from .models.predict import predict
    model = load_model(a.model, a.locus)
    geno = load_geno(a.geno, import_chr=a.import_chr, assembly=a.assembly)
    res = predict(model, geno, vote=a.vote, match_type=a.match_type,
                  engine=a.engine, type=a.type, verbose=a.verbose,
                  device=a.device)
    out = a.out
    if out.lower().endswith((".vcf", ".vcf.gz")):
        from .io.vcf import write_vcf
        write_vcf(res, out, assembly=a.assembly, prob_cutoff=a.prob_cutoff)
    else:
        import contextlib
        # nullcontext: "--out -" must not close sys.stdout on block exit
        with (open(out, "w") if out != "-"
              else contextlib.nullcontext(sys.stdout)) as f:
            f.write("sample.id\tallele1\tallele2\tprob\tmatching\n")
            for s, a1, a2, p, m in zip(res.sample_id, res.allele1,
                                       res.allele2, res.prob, res.matching):
                f.write(f"{s}\t{a1}\t{a2}\t{p:.6g}\t{m:.6g}\n")
    print(f"imputed {len(res.sample_id)} samples "
          f"({model.locus}, {model.n_classifiers} classifiers) -> {out}",
          file=sys.stderr)
    return 0


def cmd_train(a) -> int:
    from .data.allele import flanking_snps
    from .models.train import train_parallel
    hla = load_hla_table(a.hla, a.locus)
    geno = load_geno(a.geno, import_chr=a.import_chr, assembly=a.assembly)
    if a.flank_bp > 0:
        ids = flanking_snps(geno.snp_id, geno.snp_position, a.locus,
                            a.flank_bp, a.assembly)
        n_all = geno.n_snp
        geno = geno.subset(snp_mask=np.isin(geno.snp_id.astype(str),
                                            ids.astype(str)))
        print(f"flank filter ({a.flank_bp} bp around {a.locus}): "
              f"{geno.n_snp} of {n_all} SNPs kept", file=sys.stderr)
    model = train_parallel(
        hla, geno, n_classifiers=a.n_classifiers, mtry=a.mtry,
        prune=not a.no_prune, seed=a.seed, mode=a.mode, hcap=a.hcap,
        on_overflow=a.on_overflow, auto_save=a.auto_save,
        resume=a.resume, verbose=not a.quiet, device=a.device)
    model.save(a.out)
    oob = float(np.mean([c.oob_accuracy for c in model.classifiers]))
    print(f"saved {a.out}: {model.n_classifiers} classifiers, "
          f"mean OOB accuracy {oob:.4f}", file=sys.stderr)
    return 0


def cmd_convert(a) -> int:
    p = a.input.lower()
    model_out_r = a.out.lower().endswith((".rdata", ".rda"))
    if (p.endswith((".rdata", ".rda", ".rds"))
            or (p.endswith(".npz") and model_out_r)) and not a.geno:
        model = load_model(a.input, a.locus)
        if model_out_r:
            # export back to R HIBAG (load() + hlaModelFromObj)
            from .models.publish import save_rdata
            save_rdata(model, a.out)
        else:
            model.save(a.out)
        print(f"model {a.input} -> {a.out} "
              f"({model.n_classifiers} classifiers, locus {model.locus})",
              file=sys.stderr)
    else:
        geno = load_geno(a.input, import_chr=a.import_chr,
                         assembly=a.assembly)
        save_geno(geno, a.out)
        print(f"genotypes {a.input} -> {a.out} "
              f"({geno.n_snp} SNPs x {geno.n_samp} samples)",
              file=sys.stderr)
    return 0


def cmd_summary(a) -> int:
    p = a.input.lower()
    if p.endswith((".bed", ".gds", ".vcf", ".vcf.gz")) or a.geno:
        geno = load_geno(a.input, import_chr="", assembly=a.assembly)
        from .data.misc import summary_geno
        print(summary_geno(geno))
        return 0
    try:
        model = load_model(a.input, a.locus)
    except SystemExit:
        geno = load_geno(a.input, import_chr="", assembly=a.assembly)
        from .data.misc import summary_geno
        print(summary_geno(geno))
        return 0
    from .models.introspect import summarize
    s = summarize(model)
    compact = {k: v for k, v in s.items()
               if not isinstance(v, np.ndarray)}
    compact["locus"] = model.locus
    compact["n.hla.allele"] = model.n_alleles
    try:
        print(json.dumps(compact, indent=1, default=str))
    except BrokenPipeError:
        pass
    return 0


def cmd_report(a) -> int:
    from .eval.compare import compare_alleles
    from .eval.report import report
    truth = load_hla_table(a.truth, a.locus)
    rows = [l.rstrip("\n").split("\t") for l in open(a.pred)]
    hdr = rows[0]
    cols = {k: [r[i] for r in rows[1:]] for i, k in enumerate(hdr)}
    from .data.allele import HLATypeTable
    pred = HLATypeTable.from_alleles(
        np.array(cols["sample.id"], dtype=object),
        np.array(cols["allele1"], dtype=object),
        np.array(cols["allele2"], dtype=object),
        locus=a.locus, assembly="hg19")
    cmp = compare_alleles(truth, pred)
    print(report(cmp, fmt=a.format))
    return 0


def _mtry(value: str):
    """--mtry: "sqrt", "all", "one", or a number (a count, or a fraction of
    the SNPs below 1), as train_parallel takes it. hibag_tpu's CLI passes
    the number on as a string, which its train_parallel refuses."""
    if value in ("sqrt", "all", "one"):
        return value
    try:
        return float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid mtry {value!r}: sqrt, all, one or a number") from None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m hibag_tpu_torch",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common_geno(p):
        p.add_argument("--import-chr", default="",
                       help='region filter, e.g. "xMHC" (default: all)')
        p.add_argument("--assembly", default="hg19")

    def common_device(p):
        p.add_argument("--device", default="cuda",
                       help='torch device: "cuda" (default; raises without '
                            'a card) or "cpu"')

    p = sub.add_parser("impute", help="impute HLA types")
    p.add_argument("--model", required=True)
    p.add_argument("--geno", required=True)
    p.add_argument("--out", required=True,
                   help=".tsv, .vcf[.gz], or - for stdout")
    p.add_argument("--locus", default=None)
    p.add_argument("--vote", default="prob", choices=["prob", "majority"])
    p.add_argument("--match-type", default="Position",
                   choices=["Position", "Pos+Allele", "RefSNP+Position",
                            "RefSNP"])
    p.add_argument("--engine", default="auto",
                   choices=["auto", "jnp", "pallas"],
                   help="pallas: the ensemble kernel; jnp: the "
                        "per-classifier scan on the scoring kernel; auto: "
                        "the ensemble kernel where it takes the model")
    p.add_argument("--type", default=None,
                   choices=["response+dosage", "response", "prob",
                            "response+prob"])
    p.add_argument("--prob-cutoff", type=float, default=float("nan"))
    p.add_argument("--verbose", action="store_true")
    common_geno(p)
    common_device(p)
    p.set_defaults(fn=cmd_impute)

    p = sub.add_parser("train", help="train an attribute-bagging model")
    p.add_argument("--hla", required=True,
                   help="TSV/RData table with sample.id + allele columns")
    p.add_argument("--geno", required=True)
    p.add_argument("--locus", required=True)
    p.add_argument("--out", required=True, help="output model .npz")
    p.add_argument("--n-classifiers", type=int, default=100)
    p.add_argument("--mtry", default="sqrt", type=_mtry,
                   help='"sqrt" (default), "all", "one" or a number')
    p.add_argument("--no-prune", action="store_true")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--mode", default="auto",
                   choices=["auto", "host", "fused"])
    p.add_argument("--hcap", type=int, default=256)
    p.add_argument("--on-overflow", default="warn",
                   choices=["warn", "retry", "freeze"])
    p.add_argument("--flank-bp", type=int, default=500_000,
                   help="restrict to SNPs within this flank of the locus "
                        "(0 = keep all)")
    p.add_argument("--auto-save", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--quiet", action="store_true")
    common_geno(p)
    common_device(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("convert",
                       help="convert genotype/model containers to .npz")
    p.add_argument("input")
    p.add_argument("out")
    p.add_argument("--locus", default=None)
    p.add_argument("--geno", action="store_true",
                   help="force genotype interpretation")
    common_geno(p)
    common_device(p)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("summary", help="describe a model or genotype file")
    p.add_argument("input")
    p.add_argument("--locus", default=None)
    p.add_argument("--geno", action="store_true")
    p.add_argument("--assembly", default="hg19")
    common_device(p)
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("report", help="accuracy report vs a truth table")
    p.add_argument("--pred", required=True, help="impute --out TSV")
    p.add_argument("--truth", required=True)
    p.add_argument("--locus", required=True)
    p.add_argument("--format", default="txt",
                   choices=["txt", "tex", "html", "md"])
    common_device(p)
    p.set_defaults(fn=cmd_report)
    return ap


def main(argv=None) -> int:
    from .device import resolve_device
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
