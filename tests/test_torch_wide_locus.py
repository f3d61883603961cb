"""A wide HLA locus on the CPU, against the benchmark's plain float64
reference (portbench/reference) on seeded synthetic models
(portbench/gen/synthetic.py): predict(engine="auto") takes the scan engine
past the ensemble kernel's alleles (ens_acc.MAX_A) and past its slots
(ens_acc.MAX_H), records its ``predict.scan`` / ``predict.fold`` spans and
``predict.scan_chunks`` counter only while tracing is on, and matches the
reference within the ``hla_b-predict`` cell's limits; the ``hla_b`` cells
run through the harness at a tiny wide size and come out correct."""

import numpy as np
import pytest

import hibag_tpu_torch as ht
from hibag_tpu_torch.data.geno import SNPGenoData
from hibag_tpu_torch.models.model import AttrBagModel, Classifier
from hibag_tpu_torch.models.predict import SCAN_CCHUNK
from hibag_tpu_torch.ops import ens_acc
from hibag_tpu_torch.utils import trace
from portbench import run
from portbench.gen import synthetic as syn
from portbench.reference import judge
from portbench.reference import predict as ref

#: model seed, model SNPs, cohort size, samples per block
SEED, N_SNP, N_SAMPLES, BLOCK = 7, 80, 24, 8

#: a tiny configuration of the wide locus: the model and the panel draw
#: from more alleles than the ensemble kernel takes (the panel's 40
#: samples carry a few dozen of them)
TINY_WIDE = {
    "name": "tiny_wide", "missing": 0.02, "precision": "float32",
    "model": {"n_classifiers": 10, "n_snp": 80, "n_alleles": 132,
              "snp_range": [6, 14], "hap_range": [140, 200],
              "max_variants": 2, "mutation": 0.05, "shape_seed": 0},
    "panel": {"panel_seed": 0, "n_samples": 40, "n_snp": 24,
              "n_alleles": 130, "max_variants": 2, "mutation": 0.02,
              "recombination": 0.5},
}
MIXES = {
    "hla_b-predict": {
        "kind": "predict", "entry": "predict", "call": {}, "cohort": 200,
        "chunks": [128], "compare": 40, "profile_calls": 2,
        "launches": {"post_scores": [1, None], "ens_acc": [0, 0]}},
    "hla_b-train": {
        "kind": "train", "entry": "train_parallel",
        "call": {"n_classifiers": 2, "batch": 2, "mode": "fused", "mtry": 3,
                 "hcap": 256, "max_steps": 12, "on_overflow": "freeze",
                 "with_matching": False, "verbose": False},
        "train_seed": 100, "ids": 4, "warm_id": 1000, "compare": 2,
        "profile_calls": 1,
        "launches": {"train_step:evaluate_candidates_kernel": [1, None]}},
}


@pytest.fixture(autouse=True)
def _clean_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _synthetic(case):
    """(model dict, pool): "alleles", 132 alleles and at most 60
    haplotypes a classifier; "slots", 40 alleles and one classifier of
    1,030 haplotypes beside five of at most 40 (one pool: the same seed
    and sizes draw the same pool first)."""
    if case == "alleles":
        return syn.synthetic_model(SEED, 10, N_SNP, 132, [6, 14], [20, 60],
                                   3, 0.05, 0)
    m, pool = syn.synthetic_model(SEED, 5, N_SNP, 40, [25, 30], [10, 40], 3,
                                  0.05, 0)
    wide, _ = syn.synthetic_model(SEED, 1, N_SNP, 40, [25, 30],
                                  [1030, 1030], 3, 0.05, 0)
    m["classifiers"].append(wide["classifiers"][0])
    return m, pool


def _port(m, geno):
    """The program's model and cohort from the generator's arrays."""
    P = len(m["snp_position"])
    snp_id = np.array([f"rs{i}" for i in range(P)], dtype=object)
    snp_allele = np.array(["A/G"] * P, dtype=object)
    model = AttrBagModel(
        locus="B", snp_id=snp_id, snp_position=m["snp_position"],
        snp_allele=snp_allele, hla_alleles=list(m["alleles"]),
        classifiers=[Classifier(**c) for c in m["classifiers"]],
        snp_allele_freq=m["snp_allele_freq"], hla_freq=m["hla_freq"],
        assembly="hg19")
    data = SNPGenoData(
        genotype=geno, sample_id=np.array(
            [f"s{i}" for i in range(geno.shape[1])], dtype=object),
        snp_id=snp_id, snp_position=m["snp_position"],
        snp_allele=snp_allele, assembly="hg19")
    return model, data


def _cells(res, alleles):
    """Best cell index (upper triangle, row-major; -1 where no call)."""
    A = len(alleles)
    idx = {a: i for i, a in enumerate(alleles)}
    out = []
    for a1, a2 in zip(res.allele1, res.allele2):
        if a1 is None:
            out.append(-1)
            continue
        x, y = sorted((idx[a1], idx[a2]))
        out.append(x * A - x * (x - 1) // 2 + (y - x))
    return np.array(out)


@pytest.fixture(scope="module", params=["alleles", "slots"])
def wide(request):
    m, pool = _synthetic(request.param)
    geno, _, _ = syn.synthetic_cohort(pool, N_SAMPLES, SEED + 1, 0.02)
    hm = max(len(c["hap_freq"]) for c in m["classifiers"])
    assert not ens_acc.fits(hm, len(m["alleles"]))
    return m, geno


def test_scan_engine_traced_and_matches_the_reference(wide):
    """engine="auto" past the ensemble kernel's range: one predict.scan
    span holding one predict.fold span and one predict.scan_chunks count
    per chunk of SCAN_CCHUNK classifiers and block, every chunk counted in
    predict.scan_fused (the probability vote folds in the scoring kernel's
    fold mode) and none under the majority vote, which still records its
    predict.fold spans; and the calls, probabilities and matching of the
    float64 reference within the hla_b-predict cell's limits. (On a card
    the post_scores launch records carry the mode as dims["fold"]:
    tests/test_torch_gpu.py::test_scan_engine_folds_in_the_kernel.)"""
    m, geno = wide
    model, data = _port(m, geno)
    trace.enable()
    res = ht.predict(model, data, device="cpu", block=BLOCK)
    snap = trace.snapshot()
    C = len(m["classifiers"])
    chunks = -(-C // SCAN_CCHUNK) * -(-N_SAMPLES // BLOCK)
    scans = [s for s in snap["spans"] if s["name"] == "predict.scan"]
    folds = [s for s in snap["spans"] if s["name"] == "predict.fold"]
    assert len(scans) == len(folds) == chunks
    assert sorted(f["parent"] for f in folds) == sorted(s["id"]
                                                        for s in scans)
    blocks = {s["id"] for s in snap["spans"] if s["name"] == "predict.block"}
    assert all(s["parent"] in blocks for s in scans)
    counters = trace.summary(snap)["counters"]
    assert counters["predict.scan_chunks"] == chunks
    assert counters["predict.scan_fused"] == chunks

    trace.reset()
    ht.predict(model, data, device="cpu", block=BLOCK, vote="majority")
    snap = trace.snapshot()
    counters = trace.summary(snap)["counters"]
    assert counters["predict.scan_chunks"] == chunks
    assert counters.get("predict.scan_fused", 0) == 0
    assert sum(s["name"] == "predict.fold" for s in snap["spans"]) == chunks

    codes = ref.align(m["snp_position"], m["snp_position"], geno)
    want = ref.predict(m, codes, "cpu")
    got = judge.predict(want, _cells(res, m["alleles"]), res.prob,
                        res.matching)
    limits = run.load_json("portbench", "limits", "hla_b-predict.json")
    for name in ("answer_gap", "matching_gap"):
        assert got[name] <= limits[name], (name, got[name])


def test_scan_engine_untraced_records_nothing(wide):
    """Tracing off, the scan engine records no span and no counter, and
    gives the traced call's answers bitwise."""
    m, geno = wide
    model, data = _port(m, geno)
    off = ht.predict(model, data, device="cpu", block=BLOCK)
    assert trace.snapshot() == {"spans": [], "counters": [], "launches": []}
    trace.enable()
    on = ht.predict(model, data, device="cpu", block=BLOCK)
    np.testing.assert_array_equal(off.prob, on.prob)
    np.testing.assert_array_equal(off.matching, on.matching)
    assert list(off.allele1) == list(on.allele1)


@pytest.mark.parametrize("trace_on", [0, 1])
@pytest.mark.parametrize("cell", ["hla_b-predict", "hla_b-train"])
def test_wide_cell_correct_on_the_cpu(cell, trace_on):
    """Each hla_b cell through the harness (portbench.run.run_cell) at the
    tiny wide size, held to the cell's own limits: correct."""
    bench = run.load_json("BENCHMARK.json")
    r = run.run_cell(bench, cell, 2**31 + 54321, 0.1, trace_on,
                     device="cpu", cfg=TINY_WIDE, mix=MIXES[cell],
                     log=lambda *a: None)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    limits = run.load_json("portbench", "limits", f"{cell}.json")
    assert set(r["checks"]) == set(limits)
