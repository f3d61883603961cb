"""hibag_tpu_torch.ops.post_scores (the scoring kernel's module) and the scan
prediction engine built on it, held against hibag_tpu on the same seeded
inputs: ensemble_scores_pallas and classifier_posteriors run in interpret
mode, _predict_block's "jnp" engine, and predict() of a model wider than the
ensemble kernel takes. On the CPU the wrappers run the plain version; the
CUDA kernel itself is held against it by tests/test_torch_gpu.py and by
chip_smoke.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import hibag_tpu
import hibag_tpu_torch
from hibag_tpu.models.predict import _predict_block as jax_predict_block
from hibag_tpu.ops import scoring_pallas
from hibag_tpu.ops.scoring import geno_coefficients
from hibag_tpu_torch.models import predict as port_predict
from hibag_tpu_torch.models.convert import (classifier_from_jax_prepared,
                                            ensemble_from_jax_prepared)
from hibag_tpu_torch.ops import ens_acc, post_scores
from hibag_tpu_torch.utils import trace
from hibag_tpu_torch.utils.synthetic import synthetic_cohort, synthetic_model
from test_torch_ens_acc import _inputs
from test_torch_scoring import _classifier

torch.set_num_threads(2)

L = 128
#: tests/test_pallas.py:33-38's tolerance for the scoring kernel
RTOL, ATOL = 2e-4, 1e-30


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _assert_scores(got, want, A):
    """got: the port's (S, dmin, total); want: hibag_tpu's, S padded."""
    S, dmin, total = (x.numpy() for x in got)
    Sj, dminj, totalj = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(dmin, dminj)
    np.testing.assert_allclose(S, Sj[..., :A, :A], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(total, totalj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,A,tie", [(0, 9, False), (1, 128, True)])
def test_ensemble_scores_matches_pallas_kernel(seed, A, tie):
    C, H, N = 2, 128, 8
    hb, W, valid, g, _ = _inputs(seed, C, H, N, A, tie)
    alpha, u, m1 = geno_coefficients(jnp.asarray(g))
    want = scoring_pallas.ensemble_scores_pallas(
        jnp.asarray(hb), jnp.asarray(W), jnp.asarray(valid), alpha[..., None],
        u, m1, interpret=True)
    hap = ensemble_from_jax_prepared(hb, W, valid, "cpu")
    before = post_scores.LAUNCHES
    got = post_scores.ensemble_scores(hap, torch.from_numpy(g), A)
    assert post_scores.LAUNCHES == before  # the CPU path launches nothing
    _assert_scores(got, want, A)
    if tie:
        S = got[0]
        assert S[0, 3, 0, 2] == S[0, 3, 1, 2] > 0


@pytest.mark.parametrize("pattern,dominant", [
    ("all4", False), ("none", False), ("word3", False), (None, True),
    ("all4", True)])
def test_het_patterns_and_dominant_allele(pattern, dominant):
    """The cases the kernel's distance and cell walk branch on: heterozygous
    codes in all four 32-SNP words, in none, only in word 3; and a
    classifier whose first allele holds most haplotypes."""
    C, H, N, A = 2, 128, 8, 14
    hb, W, valid, g, _ = _inputs(8, C, H, N, A, True, pattern, dominant)
    alpha, u, m1 = geno_coefficients(jnp.asarray(g))
    want = scoring_pallas.ensemble_scores_pallas(
        jnp.asarray(hb), jnp.asarray(W), jnp.asarray(valid), alpha[..., None],
        u, m1, interpret=True)
    hap = ensemble_from_jax_prepared(hb, W, valid, "cpu")
    got = post_scores.ensemble_scores(hap, torch.from_numpy(g), A)
    _assert_scores(got, want, A)
    S = got[0]
    assert S[0, 3, 0, 2] == S[0, 3, 1, 2] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_classifier_posteriors_matches_pallas(seed):
    bits, freq, allele, geno, A = _classifier(seed)
    want = scoring_pallas.classifier_posteriors(
        jnp.asarray(bits), jnp.asarray(freq), jnp.asarray(allele),
        jnp.asarray(geno), A, interpret=True)
    got = post_scores.classifier_posteriors(
        torch.from_numpy(bits), torch.from_numpy(freq),
        torch.from_numpy(allele), torch.from_numpy(geno), A)
    _assert_scores((got["S"], got["dmin"], got["total"]),
                   (want["S"], want["dmin"], want["total"]), A)
    assert np.all(got["dmin"].numpy()[:2] == 0)  # all-missing samples


def test_posterior_scores_kernel_from_pallas_inputs():
    """posterior_scores_pallas' own inputs carried across at C = 1."""
    hb, W, valid, g, _ = _inputs(2, 1, 128, 16, 48)
    alpha, u, m1 = geno_coefficients(jnp.asarray(g[0]))
    want = scoring_pallas.posterior_scores_pallas(
        jnp.asarray(hb[0]), jnp.asarray(W[0]), jnp.asarray(valid[0, :, 0]),
        alpha, u, m1, interpret=True)
    hap = classifier_from_jax_prepared(hb[0], W[0], valid[0, :, 0], "cpu")
    assert hap.n_classifiers == 1
    got = post_scores.posterior_scores_kernel(hap, torch.from_numpy(g[0]), 48)
    _assert_scores(got, want, 48)


def test_ordered_pairs():
    """Two haplotypes of allele 0 and one of allele 1 (and a padded slot):
    S sums ordered pairs, so S[0,1] == S[1,0] holds each cross pair once
    per order, S[0,0] the pair within allele 0 twice, and total the full
    matrix; against a float64 sum over ordered pairs."""
    hap, g, want = chip_smoke._ordered_pair_case(torch.device("cpu"))
    S, dmin, total = post_scores.ensemble_scores(hap, g, 3)
    np.testing.assert_allclose(S.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(total.numpy(), want.sum((-1, -2)), rtol=RTOL)
    assert np.all(S.numpy()[..., 2, :] == 0)  # an allele with no haplotype


def test_pair_popc_counts_heterozygous_words():
    """chip_smoke's popcount count for the bounds: one per unordered valid
    pair and 32-slot word of the sample that holds a heterozygous code."""
    g = torch.full((2, 2, L), 3, dtype=torch.int8)
    g[0, 0, [5, 40, 41]] = 1     # words 0 and 1
    g[0, 1] = 0                  # homozygous only: no word
    g[1, 1, 100] = 1             # word 3
    g[1, 0, :32] = 2
    assert chip_smoke._pair_popc(torch.tensor([3, 1]), g) == 6 * 2 + 1 * 1


def _scan_inputs(seed, C=6, H=24, A=9, n=16, P=300):
    """tests/test_pallas.py::test_ensemble_accumulate_matches_scan's
    ensemble: classifiers of different SNP and haplotype counts."""
    rng = np.random.default_rng(seed)
    hb = np.zeros((C, H, L), np.float32)
    hf = np.zeros((C, H), np.float32)
    ha = np.zeros((C, H), np.int32)
    si = np.full((C, L), -1, np.int32)
    for c in range(C):
        ns = rng.integers(8, 20)
        nh = rng.integers(6, H)
        hb[c, :nh, :ns] = rng.integers(0, 2, (nh, ns))
        f = rng.random(nh)
        hf[c, :nh] = f / f.sum()
        ha[c, :nh] = np.sort(rng.integers(0, A, nh))
        si[c, :ns] = rng.permutation(P)[:ns]
    sw = np.zeros(P, np.int32)
    for c in range(C):
        sw[si[c][si[c] >= 0]] += 1
    geno = rng.integers(0, 4, (n, P)).astype(np.uint8)
    return hb, hf, ha, si, sw, geno, A


@pytest.mark.parametrize("cchunk", [1, 3])
@pytest.mark.parametrize("vote", ["prob", "majority"])
def test_predict_block_matches_hibag_tpu(cchunk, vote):
    hb, hf, ha, si, sw, geno, A = _scan_inputs(11)
    ens_j, wsum_j, lm_j, w_j = jax_predict_block(
        *map(jnp.asarray, (hb, hf, ha, si, sw, geno)), A, vote, "jnp", cchunk)
    hap = ens_acc.pack_haplotypes(hb, hf, ha, A, "cpu")
    ens, wsum, lm, w = port_predict._predict_block(
        hap, *map(torch.from_numpy, (si, sw, geno)), A, vote, cchunk)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-6)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(wsum_j), atol=1e-5)
    np.testing.assert_allclose(ens.numpy(), np.asarray(ens_j), rtol=3e-4,
                               atol=1e-7)
    np.testing.assert_allclose(lm.numpy(), np.asarray(lm_j), rtol=1e-3,
                               atol=1e-3)


def _traced(fn):
    """fn()'s result and the counters it recorded, with tracing on."""
    trace.reset()
    trace.enable()
    try:
        out = fn()
        return out, trace.summary()["counters"]
    finally:
        trace.disable()
        trace.reset()


def _fold_smem(H, A, records):
    """csrc/post_scores.cu::fold_smem_bytes: the slot records (24 bytes a
    slot, unless in device memory), the penalty table and the allele
    starts."""
    return 24 * H * records + 4096 + 4 * (A + 1)


def _fold_scratch(A):
    """csrc/post_scores.cu::hibag_post_scores_fold_scratch: each cell's
    value and running sum (floats) and minimum (an unsigned short), padded
    to whole floats."""
    ntri = A * (A + 1) // 2
    return 4 * (2 * ntri + (ntri + 1) // 2)


@pytest.mark.parametrize("A,C", [(160, 16), (200, 8), (160, 11)])
def test_fold_route_matches_the_s_path_and_fold(A, C):
    """The scan engine's fold route (vote="prob", float32: the scoring
    kernel's fold mode, here its plain version) at wide loci, past the S
    mode's shared running minima (A=200) and with an uneven last chunk
    (C=11): every chunk counted as fused, and ens, wsum, log_match and w
    within 1e-6 of the S path and the fold it replaced, written out."""
    hb, hf, ha, si, sw, geno, _ = _scan_inputs(21 + C, C=C, H=48, A=A, n=6)
    hap = ens_acc.pack_haplotypes(hb, hf, ha, A, "cpu")
    si, sw, geno = map(torch.from_numpy, (si, sw, geno))
    (ens, wsum, lm, w), counts = _traced(
        lambda: port_predict._scan_raw(hap, si, sw, geno, A, "prob"))
    chunks = -(-C // port_predict.SCAN_CCHUNK)
    assert counts["predict.scan_fused"] == counts["predict.scan_chunks"] \
        == chunks
    want = torch.zeros_like(ens)
    for c0 in range(0, C, port_predict.SCAN_CCHUNK):
        c1 = min(c0 + port_predict.SCAN_CCHUNK, C)
        g, wc = port_predict._gather_codes(si[c0:c1], sw, geno)
        S, dmin, total = post_scores.ensemble_scores(hap.subset(c0, c1), g,
                                                     A)
        Q = S * (2.0 - torch.eye(A))
        want += (Q * (wc / total.clamp_min(1e-30))[..., None, None]).sum(0)
        np.testing.assert_allclose(
            lm[c0:c1].numpy(), port_predict._log_match(wc, total, dmin),
            rtol=1e-6)
    assert want.abs().sum() > 0
    np.testing.assert_allclose(ens.numpy(), want.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(wsum.numpy(), w.sum(0).numpy(), rtol=1e-6)


@pytest.mark.parametrize("route", ["majority", "float64", "one classifier"])
def test_s_mode_routes(route, monkeypatch):
    """The majority vote (each classifier's argmax of Q), float64 and one
    classifier (posterior_scores_kernel, classifier_posteriors) keep the
    S mode: no chunk is fused and the fold mode is never entered."""
    def no_fold(*a, **k):
        raise AssertionError("the fold mode was entered")

    monkeypatch.setattr(post_scores, "fold_scores", no_fold)
    monkeypatch.setattr(port_predict, "fold_scores", no_fold)
    A = 9
    hb, hf, ha, si, sw, geno, _ = _scan_inputs(31, A=A)
    si, sw, geno = map(torch.from_numpy, (si, sw, geno))
    if route == "one classifier":
        bits, freq, allele, g, A = _classifier(0)
        got = post_scores.classifier_posteriors(
            torch.from_numpy(bits), torch.from_numpy(freq),
            torch.from_numpy(allele), torch.from_numpy(g), A)
        assert tuple(got["S"].shape) == (g.shape[0], A, A)
        return
    if route == "majority":
        hap = ens_acc.pack_haplotypes(hb, hf, ha, A, "cpu")
        vote, f64 = "majority", False
    else:
        hap = (torch.from_numpy(hb), torch.from_numpy(hf).double(),
               torch.from_numpy(ha))
        vote, f64 = "prob", True
    (ens, wsum, _, _), counts = _traced(lambda: port_predict._scan_raw(
        hap, si, sw, geno, A, vote, cchunk=3, f64=f64))
    assert counts["predict.scan_chunks"] == 2
    assert "predict.scan_fused" not in counts
    assert float(wsum.sum()) > 0 and float(ens.sum()) > 0


@pytest.mark.parametrize("H,A,N,want", [
    (1197, 160, 3840, (True, 3840, 0)),  # hla_b-predict: records shared
    (4096, 160, 1024, (False, 1024, 1024 * 98304)),  # records past 56 KB
    (1197, 200, 3840, (True, 2670, 0)),  # scratch past FOLD_SCRATCH_BYTES
    (640, 1024, 96, (True, 96, 0))])     # the kernel's widest alleles
def test_fold_plan(H, A, N, want):
    """fold_plan's route: the slot records in shared memory where they
    leave room for four blocks an SM, else in device memory;
    one block a sample where FOLD_SCRATCH_BYTES holds their scratch, else
    as many blocks as it holds (each then takes several samples)."""
    assert post_scores.fold_plan(H, A, N, _fold_smem, _fold_scratch) == want


@pytest.fixture(scope="module")
def wide_case(tmp_path_factory):
    """A model of 130 alleles whose classifiers hold more than 1,024
    haplotypes, saved by the port and loaded by hibag_tpu, and a cohort of
    24 samples."""
    model, pool = synthetic_model(5, n_classifiers=2, n_snp=300,
                                  n_alleles=130, snp_range=(20, 40),
                                  hap_range=(1030, 1100), max_variants=20,
                                  mutation=0.1)
    geno, _, _ = synthetic_cohort(model, pool, 24, 6, missing=0.1)
    path = str(tmp_path_factory.mktemp("wide") / "model.npz")
    model.save(path)
    jmodel = hibag_tpu.AttrBagModel.load(path)
    jgeno = hibag_tpu.SNPGenoData(
        genotype=geno.genotype, sample_id=geno.sample_id, snp_id=geno.snp_id,
        snp_position=geno.snp_position, snp_allele=geno.snp_allele,
        assembly=geno.assembly)
    return model, jmodel, geno, jgeno


def test_wide_model_predict_matches_hibag_tpu(wide_case):
    model, jmodel, geno, jgeno = wide_case
    nh = max(c.n_haplo for c in model.classifiers)
    assert nh > ens_acc.MAX_H and model.n_alleles > ens_acc.MAX_A
    assert not ens_acc.fits(nh, model.n_alleles)
    r = hibag_tpu_torch.predict(model, geno, device="cpu", with_prob=True,
                                with_dosage=True)
    j = hibag_tpu.predict(jmodel, jgeno, with_prob=True, with_dosage=True)
    top = -np.sort(-j.postprob, axis=0)[:2]
    clear = top[0] - top[1] > 1e-4 * top[0]
    assert clear.sum() > 0.8 * len(clear)
    np.testing.assert_array_equal(r.allele1[clear], j.allele1[clear])
    np.testing.assert_array_equal(r.allele2[clear], j.allele2[clear])
    np.testing.assert_allclose(r.prob, j.prob, rtol=3e-4)
    np.testing.assert_allclose(r.postprob, j.postprob, rtol=3e-4, atol=1e-7)
    np.testing.assert_allclose(r.dosage, j.dosage, rtol=3e-4, atol=1e-7)
    np.testing.assert_allclose(r.matching, j.matching, rtol=1e-3)


def test_limits_and_bad_input_raise():
    rng = np.random.default_rng(3)
    big = post_scores.MAX_H + 1
    hap = ens_acc.pack_haplotypes(rng.integers(0, 2, (1, big, L)),
                                  np.full((1, big), 1.0 / big),
                                  np.zeros((1, big), int), 4, "cpu")
    g = torch.full((1, 2, L), 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="MAX_H"):
        post_scores.ensemble_scores(hap, g, 4)
    with pytest.raises(ValueError, match="MAX_A"):
        post_scores.check_limits(8, post_scores.MAX_A + 1)
    hb, W, valid, g, _ = _inputs(4, 2, 128, 8, 9)
    hap = ensemble_from_jax_prepared(hb, W, valid, "cpu")
    with pytest.raises(ValueError, match="int8"):
        post_scores.ensemble_scores(hap, torch.from_numpy(g).int(), 9)
    with pytest.raises(ValueError, match="one classifier"):
        post_scores.posterior_scores_kernel(hap, torch.from_numpy(g[0]), 9)
    with pytest.raises(ValueError, match="contiguous"):
        post_scores.ensemble_scores(
            hap, torch.from_numpy(g).transpose(0, 1).contiguous()
            .transpose(0, 1), 9)
