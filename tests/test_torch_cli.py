"""The port's CLI (`python -m hibag_tpu_torch impute|train|convert|summary|
report --device cpu`) held against hibag_tpu's (`python -m hibag_tpu`, JAX on
the CPU) on the same seeded synthetic files: calls and text exact, prob and
matching at rtol 1e-4 (DEVIATIONS #1), trained classifiers equal. Also the
engine names of predict() and the refusals: --device cuda without a card,
engine="pallas" past the ensemble kernel's limits."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import hibag_tpu  # noqa: E402
import hibag_tpu_torch  # noqa: E402
from hibag_tpu import cli as jcli  # noqa: E402
from hibag_tpu_torch import cli as tcli  # noqa: E402
from hibag_tpu_torch.ops import ens_acc  # noqa: E402
from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,  # noqa: E402
                                             synthetic_model,
                                             synthetic_panel)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _truth_tsv(path, sample_id, a1, a2, locus="A"):
    with open(path, "w") as f:
        f.write(f"sample.id\t{locus}.1\t{locus}.2\n")
        for s, x, y in zip(sample_id, a1, a2):
            f.write(f"{s}\t{x}\t{y}\n")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A seeded synthetic model (10 classifiers, 300 SNPs, 8 alleles) as
    .npz, .RData and a two-locus model list; its 50-sample cohort as PLINK,
    VCF and BGZF VCF with the truth as TSV; a typed mosaic panel (96
    samples, 60 SNPs, 6 alleles) as PLINK with its HLA table."""
    d = tmp_path_factory.mktemp("cli")
    model, pool = synthetic_model(11, n_classifiers=10, n_snp=300,
                                  n_alleles=8)
    model.save(str(d / "m.npz"))
    hibag_tpu_torch.save_rdata(model, str(d / "m.RData"))
    other, _ = synthetic_model(12, n_classifiers=4, n_snp=300, n_alleles=5)
    other.locus = "B"
    hibag_tpu_torch.save_rdata({"B": other, "A": model},
                               str(d / "list.RData"))
    geno, t1, t2 = synthetic_cohort(model, pool, 50, 13)
    f = {"dir": d, "model": model, "geno": geno,
         "bed": chip_smoke.write_plink(geno, str(d / "c")),
         "vcf": chip_smoke.write_geno_vcf(geno, str(d / "c.vcf")),
         "vcf.gz": chip_smoke.write_geno_vcf(geno, str(d / "c.vcf.gz")),
         "truth": _truth_tsv(d / "truth.tsv", geno.sample_id, t1, t2)}
    (table, pgeno), _ = synthetic_panel(1, 96, 60, 6, recombination=10.0)
    f["panel_bed"] = chip_smoke.write_plink(pgeno, str(d / "panel"))
    f["panel_hla"] = _truth_tsv(d / "panel.tsv", table.sample_id,
                                table.allele1, table.allele2)
    return f


def _run(main, argv):
    """(exit code, stdout, stderr) of an in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _calls(path):
    rows = [ln.rstrip("\n").split("\t") for ln in open(path)]
    assert rows[0] == ["sample.id", "allele1", "allele2", "prob", "matching"]
    cols = list(zip(*rows[1:]))
    return ([list(c) for c in cols[:3]],
            np.array(cols[3], dtype=float), np.array(cols[4], dtype=float))


def _assert_same_calls(a, b):
    (ids_a, p_a, m_a), (ids_b, p_b, m_b) = _calls(a), _calls(b)
    assert ids_a == ids_b
    np.testing.assert_allclose(p_a, p_b, rtol=1e-4)
    np.testing.assert_allclose(m_a, m_b, rtol=1e-4)


def test_impute_subprocess_matches(files):
    """`python -m hibag_tpu_torch impute --device cpu` from .RData + .bed,
    as a user runs it, against `python -m hibag_tpu impute`."""
    d = files["dir"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = {}
    for pkg, extra in (("hibag_tpu", []),
                       ("hibag_tpu_torch", ["--device", "cpu"])):
        out[pkg] = str(d / f"sub_{pkg}.tsv")
        proc = subprocess.run(
            [sys.executable, "-m", pkg, "impute", "--model",
             str(d / "m.RData"), "--geno", files["bed"], "--out", out[pkg]]
            + extra, cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "imputed 50 samples (A, 10 classifiers)" in proc.stderr
    _assert_same_calls(out["hibag_tpu"], out["hibag_tpu_torch"])
    (_, a1, a2), _, _ = _calls(out["hibag_tpu_torch"])
    assert sum(x is not None for x in a1) == 50


@pytest.mark.parametrize("geno", ["bed", "vcf", "vcf.gz", "npz"])
@pytest.mark.parametrize("model", ["m.npz", "m.RData", "list.RData"])
def test_impute_matches(files, geno, model):
    """impute from every genotype container and every model file (a model
    list picked by --locus): the port's calls are hibag_tpu's."""
    d = files["dir"]
    src = files.get(geno)
    if geno == "npz":
        src = str(d / "c_geno.npz")
        assert _run(tcli.main, ["convert", files["bed"], src, "--geno",
                                "--device", "cpu"])[0] == 0
    args = ["impute", "--model", str(d / model), "--geno", src,
            "--locus", "A"]
    out = {}
    for name, main, extra in (("j", jcli.main, []),
                              ("t", tcli.main, ["--device", "cpu"])):
        out[name] = str(d / f"{name}_{geno}_{model}.tsv")
        assert _run(main, args + ["--out", out[name]] + extra)[0] == 0
    _assert_same_calls(out["j"], out["t"])


@pytest.mark.parametrize("engine", ["auto", "pallas", "jnp"])
@pytest.mark.parametrize("opts", [[], ["--vote", "majority"],
                                  ["--match-type", "RefSNP"]])
def test_impute_engines_match(files, engine, opts):
    """--engine auto|pallas|jnp (the ensemble kernel's and the scan's plain
    versions on the CPU) give hibag_tpu's calls (its jnp engine on the
    CPU), with majority voting and another SNP matching too; the ensemble
    kernel's count moves only where it runs."""
    d = files["dir"]
    args = ["impute", "--model", str(d / "m.npz"), "--geno", files["bed"]]
    want = str(d / f"j_{engine}_{len(opts)}.tsv")
    got = str(d / f"t_{engine}_{len(opts)}.tsv")
    assert _run(jcli.main, args + opts + ["--out", want, "--engine",
                                          "jnp"])[0] == 0
    before = ens_acc.LAUNCHES
    assert _run(tcli.main, args + opts + ["--out", got, "--engine", engine,
                                          "--device", "cpu"])[0] == 0
    # on the CPU the wrappers run their plain versions: no launch counted
    assert ens_acc.LAUNCHES == before
    _assert_same_calls(want, got)


@pytest.mark.parametrize("out", ["calls.vcf", "calls.vcf.gz", "-"])
def test_impute_outputs_match(files, out, capsys):
    """VCF output (plain and BGZF) equal to hibag_tpu's without the date
    line: calls exact, dosages at DEVIATIONS #1's tolerance; `--out -`
    writes the table to stdout without closing it."""
    import gzip
    d = files["dir"]
    args = ["impute", "--model", str(d / "m.npz"), "--geno", files["vcf"],
            "--prob-cutoff", "0.5"]
    if out == "-":
        res = [_run(main, args + ["--out", "-"] + extra)[1]
               for main, extra in ((jcli.main, []),
                                   (tcli.main, ["--device", "cpu"]))]
        assert not sys.stdout.closed
        rows = [[ln.split("\t")[:3] for ln in r.splitlines()] for r in res]
        assert rows[0] == rows[1] and rows[1][0][0] == "sample.id"
        return
    text = []
    for name, main, extra in (("j", jcli.main, []),
                              ("t", tcli.main, ["--device", "cpu"])):
        p = str(d / f"{name}_{out}")
        assert _run(main, args + ["--out", p] + extra)[0] == 0
        raw = pathlib.Path(p).read_bytes()
        if p.endswith(".gz"):
            assert raw[:4] == b"\x1f\x8b\x08\x04"
            raw = gzip.decompress(raw)
        text.append([ln.split("\t") for ln in raw.decode().splitlines()
                     if not ln.startswith("##fileDate")])
    # headers, records and GT calls exact; DS (a sum of float32 posteriors)
    # at rtol 1e-4, and atol 1e-6 where the ensemble holds ~0
    assert [r for r in text[0] if r[0].startswith("#")] == \
        [r for r in text[1] if r[0].startswith("#")]
    body = [[r for r in t if not r[0].startswith("#")] for t in text]
    assert [r[:9] for r in body[0]] == [r[:9] for r in body[1]]
    cells = [np.array([c.split(":") for r in b for c in r[9:]]) for b in body]
    np.testing.assert_array_equal(cells[0][:, 0], cells[1][:, 0])
    np.testing.assert_allclose(cells[0][:, 1].astype(float),
                               cells[1][:, 1].astype(float), rtol=1e-4,
                               atol=1e-6)


def test_train_matches(files):
    """train --mode host (a few classifiers, the flank filter on): the
    port's classifiers are hibag_tpu's; both print how many SNPs the flank
    keeps; impute and report with the trained model agree."""
    d = files["dir"]
    args = ["train", "--hla", files["panel_hla"], "--geno",
            files["panel_bed"], "--locus", "A", "--n-classifiers", "3",
            "--mode", "host", "--seed", "3", "--quiet"]
    models = {}
    for name, main, extra in (("j", jcli.main, []),
                              ("t", tcli.main, ["--device", "cpu"])):
        p = str(d / f"{name}_trained.npz")
        rc, _, err = _run(main, args + ["--out", p] + extra)
        assert rc == 0
        models[name] = p
    assert "flank filter (500000 bp around A): 60 of 60 SNPs kept" in err
    assert "mean OOB accuracy" in err
    want = hibag_tpu.AttrBagModel.load(models["j"])
    got = hibag_tpu_torch.AttrBagModel.load(models["t"])
    assert got.n_classifiers == want.n_classifiers == 3
    for a, b in zip(got.classifiers, want.classifiers):
        np.testing.assert_array_equal(a.snp_index, b.snp_index)
        np.testing.assert_array_equal(a.hap_bits, b.hap_bits)
        np.testing.assert_array_equal(a.hap_allele, b.hap_allele)
        np.testing.assert_allclose(a.hap_freq, b.hap_freq, rtol=1e-4)
        assert a.oob_accuracy == b.oob_accuracy
    calls = {}
    for name, main, extra in (("j", jcli.main, []),
                              ("t", tcli.main, ["--device", "cpu"])):
        calls[name] = str(d / f"{name}_self.tsv")
        assert _run(main, ["impute", "--model", models[name], "--geno",
                           files["panel_bed"], "--out", calls[name]]
                    + extra)[0] == 0
    _assert_same_calls(calls["j"], calls["t"])
    reports = [_run(main, ["report", "--pred", calls["t"], "--truth",
                           files["panel_hla"], "--locus", "A"] + extra)[1]
               for main, extra in ((jcli.main, []),
                                   (tcli.main, ["--device", "cpu"]))]
    assert reports[0] == reports[1]
    assert reports[1].startswith("Overall accuracy: ")


@pytest.mark.parametrize("mtry", ["7", "0.25", "sqrt", "bad"])
def test_train_mtry_values(files, mtry):
    """--mtry takes a count or a fraction as train_parallel does (its
    classifiers are hibag_tpu's train_parallel's with that mtry: hibag_tpu's
    CLI passes the number on as a string, which its train_parallel
    refuses); anything else ends the CLI with a usage error."""
    d = files["dir"]
    out = str(d / f"mtry_{mtry}.npz")
    argv = ["train", "--hla", files["panel_hla"], "--geno",
            files["panel_bed"], "--locus", "A", "--n-classifiers", "2",
            "--mode", "host", "--seed", "4", "--quiet", "--mtry", mtry,
            "--out", out, "--device", "cpu"]
    if mtry == "bad":
        with pytest.raises(SystemExit):
            _run(tcli.main, argv)
        return
    assert _run(tcli.main, argv)[0] == 0
    got = hibag_tpu_torch.AttrBagModel.load(out)
    hla = jcli.load_hla_table(files["panel_hla"], "A")
    geno = jcli.load_geno(files["panel_bed"])
    want = hibag_tpu.train_parallel(
        hla, geno, n_classifiers=2, mode="host", seed=4, verbose=False,
        mtry=mtry if mtry == "sqrt" else float(mtry))
    for a, b in zip(got.classifiers, want.classifiers):
        np.testing.assert_array_equal(a.snp_index, b.snp_index)
        np.testing.assert_array_equal(a.hap_bits, b.hap_bits)
        np.testing.assert_allclose(a.hap_freq, b.hap_freq, rtol=1e-4)


def test_train_flank_filter_drops_far_snps(files, tmp_path):
    """SNPs 2 Mb from HLA-A leave the panel before training; the message
    counts them."""
    (table, pgeno), _ = synthetic_panel(2, 40, 30, 4)
    pgeno.snp_position = pgeno.snp_position.copy()
    pgeno.snp_position[-5:] += 2_000_000
    bed = chip_smoke.write_plink(pgeno, str(tmp_path / "p"))
    hla = _truth_tsv(tmp_path / "p.tsv", table.sample_id, table.allele1,
                     table.allele2)
    rc, _, err = _run(tcli.main, [
        "train", "--hla", hla, "--geno", bed, "--locus", "A", "--out",
        str(tmp_path / "m.npz"), "--n-classifiers", "1", "--mode", "host",
        "--quiet", "--device", "cpu"])
    assert rc == 0
    kept = hibag_tpu_torch.flanking_snps(pgeno.snp_id, pgeno.snp_position,
                                         "A", 500_000, "hg19")
    assert 0 < len(kept) <= 25
    assert f"{len(kept)} of 30 SNPs kept" in err
    # training then drops monomorphic SNPs of those kept
    model = hibag_tpu_torch.AttrBagModel.load(str(tmp_path / "m.npz"))
    assert set(model.snp_id) <= set(kept)


def test_convert_matches(files):
    """convert .RData -> .npz -> .RData (payload byte-equal to hibag_tpu's,
    the model equal to the one that went in) and .bed -> genotype .npz."""
    import gzip
    d = files["dir"]
    outs = {}
    for name, main, extra in (("j", jcli.main, []),
                              ("t", tcli.main, ["--device", "cpu"])):
        npz, rd = str(d / f"{name}_conv.npz"), str(d / f"{name}_conv.RData")
        gnpz = str(d / f"{name}_geno.npz")
        assert _run(main, ["convert", str(d / "list.RData"), npz, "--locus",
                           "A"] + extra)[0] == 0
        assert _run(main, ["convert", npz, rd] + extra)[0] == 0
        assert _run(main, ["convert", files["bed"], gnpz, "--geno"]
                    + extra)[0] == 0
        outs[name] = (npz, rd, gnpz)
    assert gzip.open(outs["j"][1]).read() == gzip.open(outs["t"][1]).read()
    for k in (0, 2):
        zj, zt = np.load(outs["j"][k], allow_pickle=True), np.load(
            outs["t"][k], allow_pickle=True)
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            np.testing.assert_array_equal(zj[key], zt[key], err_msg=key)
    back = tcli.load_model(outs["t"][1])
    model = files["model"]
    for a, b in zip(back.classifiers, model.classifiers):
        for f in ("snp_index", "hap_bits", "hap_freq", "hap_allele"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("what", ["m.npz", "m.RData", "bed", "vcf.gz"])
def test_summary_matches(files, what):
    d = files["dir"]
    src = files[what] if what in files else str(d / what)
    out = [_run(main, ["summary", src] + extra)[1]
           for main, extra in ((jcli.main, []),
                               (tcli.main, ["--device", "cpu"]))]
    assert out[0] == out[1]
    if what.startswith("m."):
        s = json.loads(out[1])
        assert s["num.classifier"] == 10 and s["locus"] == "A"


@pytest.mark.parametrize("fmt", ["txt", "tex", "html", "md"])
def test_report_matches(files, fmt):
    d = files["dir"]
    calls = str(d / "report_calls.tsv")
    assert _run(tcli.main, ["impute", "--model", str(d / "m.npz"), "--geno",
                            files["bed"], "--out", calls, "--device",
                            "cpu"])[0] == 0
    args = ["report", "--pred", calls, "--truth", files["truth"], "--locus",
            "A", "--format", fmt]
    out = [_run(main, args + extra)[1]
           for main, extra in ((jcli.main, []),
                               (tcli.main, ["--device", "cpu"]))]
    assert out[0] == out[1] and out[1].strip()


def test_load_model_errors(files, tmp_path):
    """A file without an hlaAttrBagObj, an unknown locus of a model list and
    an unknown extension end the CLI (SystemExit) in both packages."""
    d = files["dir"]
    plain = str(tmp_path / "x.RData")
    hibag_tpu_torch.io.rdata.write_rdata(plain, {"x": np.arange(3)})
    for path, locus in ((plain, None), (str(d / "m.RData"), None),
                        (str(d / "list.RData"), "DRB1"),
                        (files["truth"], None)):
        for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
            argv = ["impute", "--model", path, "--geno", files["bed"],
                    "--out", str(tmp_path / "o.tsv")] + extra
            if locus:
                argv += ["--locus", locus]
            if path == str(d / "m.RData"):
                assert _run(main, argv)[0] == 0
                continue
            with pytest.raises(SystemExit):
                _run(main, argv)


@pytest.mark.parametrize("cmd", ["impute", "summary"])
def test_device_cuda_without_card_raises(files, cmd):
    """The default --device cuda raises without a card, before any file is
    read: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda would run")
    d = files["dir"]
    argv = (["impute", "--model", str(d / "m.npz"), "--geno", files["bed"],
             "--out", str(d / "never.tsv")] if cmd == "impute"
            else ["summary", str(d / "m.npz")])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _run(tcli.main, argv)
    assert not (d / "never.tsv").exists()


def test_predict_engine_names(files):
    """predict(engine=): "auto", "pallas", "jnp" and its alias "scan" give
    the same calls; dtype=float64 takes the scan engine whatever the
    engine; an unknown name raises."""
    model, geno = files["model"], files["geno"]
    res = {e: hibag_tpu_torch.predict(model, geno, engine=e, device="cpu")
           for e in ("auto", "pallas", "jnp", "scan")}
    for e in ("pallas", "jnp", "scan"):
        assert list(res[e].allele1) == list(res["auto"].allele1)
        assert list(res[e].allele2) == list(res["auto"].allele2)
        np.testing.assert_allclose(res[e].prob, res["auto"].prob, rtol=1e-4)
    r64 = hibag_tpu_torch.predict(model, geno, engine="pallas",
                                  dtype=np.float64, device="cpu")
    assert list(r64.allele1) == list(res["auto"].allele1)
    with pytest.raises(ValueError, match="unknown engine"):
        hibag_tpu_torch.predict(model, geno, engine="xla", device="cpu")


def test_predict_pallas_raises_past_the_kernel():
    """engine="pallas" on a model the ensemble kernel does not take (more
    than ens_acc.MAX_A alleles) raises, on any device; "auto" and "jnp" run
    the scan engine on it."""
    model, pool = synthetic_model(14, n_classifiers=2, n_snp=80,
                                  n_alleles=ens_acc.MAX_A + 2,
                                  snp_range=(10, 20), hap_range=(140, 160))
    geno, _, _ = synthetic_cohort(model, pool, 6, 15)
    with pytest.raises(ValueError, match="engine='pallas'"):
        hibag_tpu_torch.predict(model, geno, engine="pallas", device="cpu")
    a = hibag_tpu_torch.predict(model, geno, engine="auto", device="cpu")
    b = hibag_tpu_torch.predict(model, geno, engine="jnp", device="cpu")
    assert list(a.allele1) == list(b.allele1)
