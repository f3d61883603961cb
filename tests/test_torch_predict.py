"""The port's prediction slice held against hibag_tpu.predict on one seeded
synthetic model and cohort: AttrBagModel (.npz) → predict() on the CPU."""

import os

import jax
import numpy as np
import pytest
import torch

import hibag_tpu
import hibag_tpu_torch
from hibag_tpu_torch.models import predict as port_predict
from hibag_tpu_torch.models.convert import ensemble_from_jax_prepared
from hibag_tpu_torch.ops import ens_acc, post_scores
from hibag_tpu_torch.utils.synthetic import synthetic_cohort, synthetic_model

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(port model, hibag_tpu model, port geno, hibag_tpu geno, truth): the
    hibag_tpu model is the port's, saved and loaded through .npz."""
    # few SNPs per classifier and many missing codes: posteriors spread
    # over several pairs and majority votes split
    model, pool = synthetic_model(3, n_classifiers=6, n_snp=200, n_alleles=9,
                                  snp_range=(4, 12), mutation=0.15)
    geno, t1, t2 = synthetic_cohort(model, pool, 48, 4, missing=0.3)
    path = str(tmp_path_factory.mktemp("m") / "model.npz")
    model.save(path)
    jmodel = hibag_tpu.AttrBagModel.load(path)
    jgeno = hibag_tpu.SNPGenoData(
        genotype=geno.genotype, sample_id=geno.sample_id, snp_id=geno.snp_id,
        snp_position=geno.snp_position, snp_allele=geno.snp_allele,
        assembly=geno.assembly)
    return model, jmodel, geno, jgeno, (t1, t2)


def _clear(postprob, margin=1e-4):
    """Samples whose top-two posterior gap exceeds `margin` relative."""
    top = -np.sort(-postprob, axis=0)[:2]
    return top[0] - top[1] > margin * top[0]


def test_prob_matches_hibag_tpu(case):
    model, jmodel, geno, jgeno, _ = case
    r = hibag_tpu_torch.predict(model, geno, device="cpu", with_prob=True,
                                with_dosage=True)
    j = hibag_tpu.predict(jmodel, jgeno, with_prob=True, with_dosage=True)
    clear = _clear(j.postprob)
    assert clear.sum() > 0.8 * len(clear)
    np.testing.assert_array_equal(r.allele1[clear], j.allele1[clear])
    np.testing.assert_array_equal(r.allele2[clear], j.allele2[clear])
    np.testing.assert_allclose(r.prob, j.prob, rtol=3e-4)
    np.testing.assert_allclose(r.postprob, j.postprob, rtol=3e-4, atol=1e-7)
    np.testing.assert_allclose(r.dosage, j.dosage, rtol=3e-4, atol=1e-7)
    np.testing.assert_allclose(r.matching, j.matching, rtol=1e-3)
    assert r.match_info == j.match_info


def test_majority_matches_hibag_tpu(case):
    model, jmodel, geno, jgeno, _ = case
    r = hibag_tpu_torch.predict(model, geno, device="cpu", vote="majority")
    j = hibag_tpu.predict(jmodel, jgeno, vote="majority")
    np.testing.assert_array_equal(r.allele1, j.allele1)
    np.testing.assert_array_equal(r.allele2, j.allele2)
    np.testing.assert_allclose(r.prob, j.prob, rtol=1e-6)
    np.testing.assert_allclose(r.matching, j.matching, rtol=1e-3)


def test_f64_scan_matches_hibag_tpu(case):
    model, jmodel, geno, jgeno, _ = case
    r = hibag_tpu_torch.predict(model, geno, device="cpu", dtype=np.float64,
                                with_prob=True)
    with jax.enable_x64(True):
        j = hibag_tpu.predict(jmodel, jgeno, dtype=np.float64, with_prob=True)
    np.testing.assert_array_equal(r.allele1, j.allele1)
    np.testing.assert_allclose(r.postprob, j.postprob, rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(r.matching, j.matching, rtol=1e-9)


def test_response_equals_prob_argmax_and_engines_agree(case):
    model, _, geno, _, truth = case
    prob = hibag_tpu_torch.predict(model, geno, device="cpu", with_prob=True)
    resp = hibag_tpu_torch.predict(model, geno, device="cpu", type="response",
                                   block=20)
    scan = hibag_tpu_torch.predict(model, geno, device="cpu", engine="scan",
                                   type="response")
    for r in (resp, scan):
        np.testing.assert_array_equal(r.allele1, prob.allele1)
        np.testing.assert_array_equal(r.allele2, prob.allele2)
        np.testing.assert_allclose(r.prob, prob.prob, rtol=1e-6)
        assert r.dosage is None and r.postprob is None
    assert prob.accuracy_vs(*truth) > 0.9


def _wide(model):
    """One classifier of `model` with 129 alleles named: wider than the
    ensemble kernel takes, so predict() routes it to the scan engine."""
    wide = model.subset_classifiers(1)
    wide.hla_alleles = [f"{i:03d}:01" for i in range(129)]
    assert not ens_acc.fits(wide.pack().hap_bits.shape[1], 129)
    return wide


@pytest.mark.parametrize("engine", ["ensemble", "scan"])
def test_prediction_deterministic(case, engine):
    """tests/test_parity.py::test_prediction_deterministic for the port: two
    predict() calls give bitwise-equal postprob and best guesses, on the
    ensemble engine and on the scan engine of a wide model."""
    model, _, geno, _, _ = case
    if engine == "scan":
        model = _wide(model)
    r1 = hibag_tpu_torch.predict(model, geno, device="cpu", with_prob=True)
    r2 = hibag_tpu_torch.predict(model, geno, device="cpu", with_prob=True)
    np.testing.assert_array_equal(r1.postprob, r2.postprob)
    np.testing.assert_array_equal(r1.allele1, r2.allele1)
    np.testing.assert_array_equal(r1.allele2, r2.allele2)


def test_npz_from_hibag_tpu_and_jax_prepared_route(case, tmp_path):
    model, jmodel, geno, _, _ = case
    path = str(tmp_path / "from_jax.npz")
    jmodel.save(path)
    loaded = hibag_tpu_torch.AttrBagModel.load(path)
    a = hibag_tpu_torch.predict(model, geno, device="cpu", with_prob=True)
    b = hibag_tpu_torch.predict(loaded, geno, device="cpu", with_prob=True)
    np.testing.assert_array_equal(a.postprob, b.postprob)
    np.testing.assert_array_equal(a.matching, b.matching)

    from hibag_tpu.models.predict import _prepare_ensemble
    A = model.n_alleles
    jprep = _prepare_ensemble(jmodel.pack(), A)
    via_jax = ensemble_from_jax_prepared(*map(np.asarray, jprep), "cpu")
    packed = loaded.pack()
    direct = port_predict._prepare_ensemble(packed, torch.device("cpu"))
    for x, y in zip((via_jax.hb, via_jax.freq, via_jax.allele, via_jax.nh),
                    (direct.hb, direct.freq, direct.allele, direct.nh)):
        assert torch.equal(x, y)
    codes, _ = hibag_tpu_torch.align_to_model(loaded, geno)
    cpu = torch.device("cpu")
    si = torch.from_numpy(packed.snp_index)
    args = ({cpu: torch.from_numpy(packed.snp_weight)},
            {cpu: torch.from_numpy(codes)}, A, "prob", True)
    for x, y in zip(
            port_predict._predict_block_mesh([(cpu, via_jax, si)], *args),
            port_predict._predict_block_mesh([(cpu, direct, si)], *args)):
        assert torch.equal(x, y)


def test_unsupported_requests_raise(case):
    """devices= naming two cards raises on a machine with fewer, a model
    wider than the ensemble kernel takes predicts through the scan engine
    and agrees with hibag_tpu.predict, a model beyond the scoring kernel's
    limits raises, and device="cuda" without a card raises."""
    model, jmodel, geno, jgeno, _ = case
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError):
            hibag_tpu_torch.predict(model, geno, device="cpu",
                                    devices=[0, 1])
    names = [f"{i:03d}:01" for i in range(129)]
    wide, jwide = model.subset_classifiers(1), jmodel.subset_classifiers(1)
    wide.hla_alleles, jwide.hla_alleles = names, list(names)
    assert not ens_acc.fits(wide.pack().hap_bits.shape[1], 129)
    r = hibag_tpu_torch.predict(wide, geno, device="cpu", with_prob=True)
    j = hibag_tpu.predict(jwide, jgeno, with_prob=True)
    clear = _clear(j.postprob)
    assert clear.sum() > 0.5 * len(clear)
    np.testing.assert_array_equal(r.allele1[clear], j.allele1[clear])
    np.testing.assert_array_equal(r.allele2[clear], j.allele2[clear])
    np.testing.assert_allclose(r.postprob, j.postprob, rtol=3e-4, atol=1e-7)
    np.testing.assert_allclose(r.matching, j.matching, rtol=1e-3)
    wider = model.subset_classifiers(1)
    wider.hla_alleles = [f"{i:04d}:01" for i in range(post_scores.MAX_A + 1)]
    with pytest.raises(ValueError, match="MAX_A"):
        hibag_tpu_torch.predict(wider, geno, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            hibag_tpu_torch.predict(model, geno, device="cuda")
