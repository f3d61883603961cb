"""The CUDA kernels against their plain PyTorch versions, on a card: the
ensemble kernel (ops/ens_acc.py), the scoring kernel (ops/post_scores.py)
and the training-step kernels (ops/train_step.py); prediction of a wide
model, fused and host training and out_of_bag through them; prediction and
host training split over two shards on one card.

Imports neither jax nor hibag_tpu, so that on a machine with a card and no
jax it runs as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Without a card every test here skips.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from hibag_tpu_torch.ops import ens_acc, post_scores
from hibag_tpu_torch.ops import train_step as ts


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hibag_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _case(seed, C, H, N, A, dev):
    """Kernel inputs with padded slots, all-missing samples (0, 1), a
    zero-weight sample (2) and an exact tie for sample 3 in classifier 0
    (alleles 0, 1, 2 one haplotype each, 0 and 1 identical)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (C, H, 128), dtype=np.uint8)
    freq = rng.dirichlet(np.ones(H), C)
    freq[:, H - H // 8:] = 0.0
    allele = np.sort(rng.integers(3, A, (C, H)), axis=1)
    allele[0, :3] = [0, 1, 2]
    bits[0, 1] = bits[0, 0]
    freq[0, 1] = freq[0, 0]
    g = rng.integers(0, 4, (C, N, 128)).astype(np.int8)
    g[:, :2] = 3
    g[0, 3] = bits[0, 0] + bits[0, 2]
    wgt = rng.random((C, N)).astype(np.float32)
    wgt[:, 2] = 0.0
    hap = ens_acc.pack_haplotypes(bits, freq, allele, A, dev)
    return hap, torch.from_numpy(g).to(dev), torch.from_numpy(wgt).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("H,A", [(64, 9), (256, 48), (1024, 128)])
@pytest.mark.parametrize("majority", [False, True])
def test_kernel_matches_plain_version(cuda, H, A, majority):
    hap, g, wgt = _case(H + A, 3, H, 64, A, cuda)
    before = ens_acc.LAUNCHES
    ens, dmin, total = ens_acc.ensemble_accumulate(hap, g, wgt, A, majority)
    again = ens_acc.ensemble_accumulate(hap, g, wgt, A, majority)
    torch.cuda.synchronize()
    assert ens_acc.LAUNCHES == before + 2
    # two runs bitwise equal
    assert all(torch.equal(x, y) for x, y in zip((ens, dmin, total), again))
    ens_r, dmin_r, total_r = ens_acc.ensemble_accumulate_ref(hap, g, wgt, A,
                                                             majority)
    assert torch.equal(dmin, dmin_r)
    torch.testing.assert_close(total, total_r, rtol=3e-4, atol=0)
    torch.testing.assert_close(ens, ens_r, rtol=3e-4, atol=1e-7)
    if majority:
        assert ens[3, 0, 2] == 1 and ens[3, 1, 2] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("H,A,pattern,dominant", [
    (256, 48, "all4", False), (256, 48, "none", False),
    (256, 48, "word3", False), (1024, 48, None, True),
    (512, 9, "word3", True)])
def test_kernel_het_patterns_and_dominant_allele(cuda, H, A, pattern,
                                                 dominant):
    """chip_smoke.py's phase-3 cases the kernel branches on: the sample's
    heterozygous codes in all four words, in none, only in word 3; a
    classifier dominated by one allele. Two runs bitwise equal, dmin exact,
    ens and total at rtol 3e-4, prob and majority voting."""
    hap, g, wgt = chip_smoke._case(np.random.default_rng(H + A), 3, H, A, 64,
                                   cuda, pattern, dominant)
    for majority in (False, True):
        out = ens_acc.ensemble_accumulate(hap, g, wgt, A, majority)
        again = ens_acc.ensemble_accumulate(hap, g, wgt, A, majority)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(out, again))
        ref = ens_acc.ensemble_accumulate_ref(hap, g, wgt, A, majority)
        assert torch.equal(out[1], ref[1])
        torch.testing.assert_close(out[2], ref[2], rtol=3e-4, atol=0)
        torch.testing.assert_close(out[0], ref[0], rtol=3e-4, atol=1e-7)


@pytest.mark.gpu
def test_kernel_raises_on_bad_input(cuda):
    hap, g, wgt = _case(1, 2, 64, 8, 9, cuda)
    with pytest.raises(ValueError, match="one device"):
        ens_acc.ensemble_accumulate(hap, g.cpu(), wgt.cpu(), 9)
    with pytest.raises(ValueError, match="contiguous"):
        ens_acc.ensemble_accumulate(hap, g, wgt.t().contiguous().t(), 9)


@pytest.mark.gpu
@pytest.mark.parametrize("A", [1, 2])
def test_kernel_edge_shapes(cuda, A):
    """One sample, classifiers with different valid counts (one with a
    single haplotype), one or two alleles."""
    rng = np.random.default_rng(A)
    C, H = 3, 70
    bits = rng.integers(0, 2, (C, H, 128), dtype=np.uint8)
    freq = rng.random((C, H))
    freq[0, 1:] = 0.0
    freq[1, 33:] = 0.0
    allele = np.sort(rng.integers(0, A, (C, H)), axis=1)
    hap = ens_acc.pack_haplotypes(bits, freq, allele, A, cuda)
    assert hap.nh.tolist() == [1, 33, H]
    g = torch.from_numpy(rng.integers(0, 4, (C, 1, 128)).astype(np.int8))
    wgt = torch.from_numpy(rng.random((C, 1)).astype(np.float32))
    g, wgt = g.to(cuda), wgt.to(cuda)
    for majority in (False, True):
        ens, dmin, total = ens_acc.ensemble_accumulate(hap, g, wgt, A,
                                                       majority)
        ens_r, dmin_r, total_r = ens_acc.ensemble_accumulate_ref(
            hap, g, wgt, A, majority)
        assert torch.equal(dmin, dmin_r)
        torch.testing.assert_close(total, total_r, rtol=3e-4, atol=0)
        torch.testing.assert_close(ens, ens_r, rtol=3e-4, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,A,N", [(1, 64, 1, 16), (8, 256, 48, 16),
                                     (1, 1600, 160, 8), (8, 4096, 160, 4),
                                     (2, 640, 1024, 4)])
def test_scores_kernel_matches_plain_version(cuda, C, H, A, N):
    """chip_smoke.py's phase-7 checks: two runs bitwise equal, dmin exact,
    S exactly symmetric, S and total at rtol 2e-4 and atol 1e-30, the
    forced tie exact; one launch counted per call of the entry point."""
    hap, g, tie = chip_smoke._score_case(np.random.default_rng(C + H + A),
                                         C, H, A, N, cuda)
    before = post_scores.LAUNCHES
    chip_smoke._check_scores(hap, g, A, f"C={C} H={H} A={A} N={N}", tie)
    assert post_scores.LAUNCHES == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,A,pattern,dominant", [
    (8, 1024, 160, "all4", False), (8, 1024, 160, "none", False),
    (8, 1024, 160, "word3", False), (1, 4096, 160, None, True),
    (2, 1024, 300, "word3", True)])
def test_scores_kernel_het_patterns_and_dominant_allele(cuda, C, H, A,
                                                        pattern, dominant):
    """The heterozygous-word patterns and dominant-allele classifiers (whose
    large cells a warp walks; at 300 alleles the cells' minima take device
    scratch) through chip_smoke.py's phase-7 checks."""
    hap, g, tie = chip_smoke._score_case(np.random.default_rng(C + H + A),
                                         C, H, A, 4, cuda, pattern, dominant)
    chip_smoke._check_scores(hap, g, A, f"{pattern} dominant={dominant}", tie)


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
def test_predict_deterministic_on_the_card(cuda, wide):
    """Two predict(device="cuda") calls give bitwise-equal postprob and best
    guesses, through the ensemble kernel and through the scan engine's
    scoring kernel."""
    from hibag_tpu_torch import predict
    from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,
                                                 synthetic_model)

    kw = (dict(n_alleles=130, snp_range=(20, 40), hap_range=(1030, 1100),
               max_variants=20, mutation=0.1) if wide else dict(n_alleles=14))
    model, pool = synthetic_model(7, n_classifiers=6, n_snp=300, **kw)
    geno, _, _ = synthetic_cohort(model, pool, 64, 8)
    before = (ens_acc.LAUNCHES, post_scores.LAUNCHES)
    r1 = predict(model, geno, device="cuda", with_prob=True)
    r2 = predict(model, geno, device="cuda", with_prob=True)
    launched = (ens_acc.LAUNCHES - before[0], post_scores.LAUNCHES - before[1])
    assert launched[1 if wide else 0] > 0 and launched[0 if wide else 1] == 0
    np.testing.assert_array_equal(r1.postprob, r2.postprob)
    np.testing.assert_array_equal(r1.allele1, r2.allele1)
    np.testing.assert_array_equal(r1.allele2, r2.allele2)


@pytest.mark.gpu
def test_scores_kernel_ordered_pairs_and_drop_in(cuda):
    """Ordered pairs within and across alleles against a float64 sum, and
    classifier_posteriors against ops.scoring.posterior_scores."""
    from hibag_tpu_torch.ops.scoring import posterior_scores

    hap, g, want = chip_smoke._ordered_pair_case(cuda)
    for S in (post_scores.ensemble_scores(hap, g, 3)[0],
              post_scores.posterior_scores_kernel(hap, g[0], 3)[0][None]):
        torch.testing.assert_close(S.cpu().double(), torch.from_numpy(want),
                                   rtol=2e-4, atol=1e-30)
    rng = np.random.default_rng(4)
    bits = torch.from_numpy(rng.integers(0, 2, (40, 128)).astype(np.float32))
    freq = torch.from_numpy(rng.dirichlet(np.ones(40)).astype(np.float32))
    freq[35:] = 0
    allele = torch.from_numpy(np.sort(rng.integers(0, 14, 40)).astype(np.int32))
    geno = torch.from_numpy(rng.integers(0, 4, (24, 128)).astype(np.int8))
    args = [x.to(cuda) for x in (bits, freq, allele, geno)]
    got = post_scores.classifier_posteriors(*args, 14)
    ref = posterior_scores(*args, 14)
    assert torch.equal(got["dmin"], ref["dmin"])
    torch.testing.assert_close(got["S"], ref["S"], rtol=2e-4, atol=1e-30)
    torch.testing.assert_close(got["total"], ref["total"], rtol=2e-4,
                               atol=1e-30)


@pytest.mark.gpu
def test_scores_kernel_raises_on_bad_input(cuda):
    hap, g, _ = chip_smoke._score_case(np.random.default_rng(1), 2, 64, 9, 8,
                                       cuda)
    with pytest.raises(ValueError, match="one device"):
        post_scores.ensemble_scores(hap, g.cpu(), 9)
    with pytest.raises(ValueError, match="contiguous"):
        post_scores.ensemble_scores(
            hap, g.transpose(0, 1).contiguous().transpose(0, 1), 9)
    with pytest.raises(ValueError, match="one classifier"):
        post_scores.posterior_scores_kernel(hap, g[0], 9)
    with pytest.raises(ValueError, match="MAX_A"):
        post_scores.ensemble_scores(hap, g, post_scores.MAX_A + 1)


@pytest.mark.gpu
def test_wide_model_predict_runs_the_scan_kernel(cuda):
    """A model of 130 alleles and classifiers above 1,024 haplotypes
    predicts on the card through the scoring kernel, never the ensemble
    kernel, and agrees with the plain versions on the CPU."""
    from hibag_tpu_torch import predict
    from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,
                                                 synthetic_model)

    model, pool = synthetic_model(5, n_classifiers=6, n_snp=300,
                                  n_alleles=130, snp_range=(20, 40),
                                  hap_range=(1030, 1100), max_variants=20,
                                  mutation=0.1)
    geno, t1, t2 = synthetic_cohort(model, pool, 64, 6)
    before, ens_before = post_scores.LAUNCHES, ens_acc.LAUNCHES
    res = predict(model, geno, device="cuda", with_prob=True)
    torch.cuda.synchronize()
    assert post_scores.LAUNCHES > before
    assert ens_acc.LAUNCHES == ens_before
    cpu = predict(model, geno, device="cpu", with_prob=True)
    np.testing.assert_allclose(res.postprob, cpu.postprob, rtol=3e-4,
                               atol=1e-7)
    assert res.accuracy_vs(t1, t2) > 0.9


@pytest.mark.gpu
@pytest.mark.parametrize("K,C,H,A,S", [(1, 1, 128, 4, 40), (2, 17, 256, 14, 96),
                                       (1, 64, 640, 128, 24)])
def test_train_step_kernels_match_plain_versions(cuda, K, C, H, A, S):
    """chip_smoke.py's phase-3b cases: EM outputs at rtol 1e-4, counts
    exact, -2logLik at rtol 1e-4, bitwise equal run to run, one launch
    counted per call."""
    c = chip_smoke._train_case(np.random.default_rng(K + C + H), K, C, H,
                               A, S, cuda)
    calls = chip_smoke._em_calls(c)
    calls["evaluate_candidates_kernel"] = chip_smoke._eval_call(c)
    for name, (fn, ref, args) in calls.items():
        before = ts.LAUNCHES[name]
        out, out2 = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert ts.LAUNCHES[name] == before + 2
        assert all(torch.equal(x, y) for x, y in zip(out, out2))
        want = ref(*args)
        if name == "evaluate_candidates_kernel":
            assert torch.equal(out[0], want[0])
            torch.testing.assert_close(out[1], want[1], rtol=1e-4,
                                       atol=1e-6)
            if C > 1:
                assert torch.equal(out[0][:, 0], out[0][:, 1])
        else:
            for x, y in zip(out, want):
                torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-9)


@pytest.mark.gpu
def test_em_mask_tiers_agree(cuda):
    """The EM's packed and re-matched (three sample chunks through the int8
    kernel, slots padded from 248 to 256) mask tiers against its int8 tier
    through em_all_candidates: rtol 1e-4, the re-matched tier bitwise equal
    run to run (chip_smoke.py's check)."""
    assert chip_smoke._check_em_tiers(cuda) < 1e-3


@pytest.mark.gpu
def test_packed_em_edge_cases_and_plans(cuda):
    """chip_smoke.py's packed EM cases: one allele at H=1,024 (the pair
    lists overflow), S=5, every B = 0, C = 1 and C = 64 against the plain
    version at rtol 1e-4, each bitwise equal run to run, under the forced
    device-memory plan and with every sample taken by the block; classifiers
    stepped alone bitwise equal to a batch."""
    assert chip_smoke._check_packed_cases(np.random.default_rng(60),
                                          cuda) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("K,C,H,A,S", chip_smoke.PACKED_SHAPES)
def test_packed_em_alone_equals_batch(cuda, K, C, H, A, S):
    """At the shapes where the packed kernel's launches happen, a
    classifier stepped alone gives bitwise its results inside the batch,
    and the plan variants agree bitwise."""
    c = chip_smoke._train_case(np.random.default_rng(70 + H), min(K, 3), C,
                               H, A, min(S, 256), cuda, n_sel=16)
    chip_smoke._check_packed_alone(c, "alone")
    chip_smoke._packed_variants(c, "variants")


@pytest.mark.gpu
def test_eval_kernel_on_untyped_samples(cuda):
    """Untyped samples: counts exact; -2logLik at rtol 1e-4 over the samples
    whose true pair scores at least 2^-100 (chip_smoke.py's rule)."""
    c = chip_smoke._train_case(np.random.default_rng(9), 2, 17, 256, 14, 128,
                               cuda, typed=False)
    kern, ref, args = chip_smoke._eval_call(c)
    rargs, n_unresolved = chip_smoke._resolved(args)
    assert n_unresolved < int((args[9] > 0).sum())
    chip_smoke._check_train_kernel("evaluate_candidates_kernel", kern, ref,
                                   args, "untyped", check_ll=False)
    chip_smoke._check_train_kernel("evaluate_candidates_kernel", kern, ref,
                                   rargs, "untyped, resolved")


@pytest.mark.gpu
@pytest.mark.parametrize("het_words", [0, 1, 2, 3, 4])
def test_eval_kernel_heterozygous_words(cuda, het_words):
    """Samples with heterozygous codes in exactly `het_words` of the four
    32-SNP words (the kernel's distance is compiled per count): counts
    exact, -2logLik at rtol 1e-4, bitwise equal run to run."""
    c = chip_smoke._train_case(np.random.default_rng(30 + het_words), 2, 17,
                               256, 14, 48, cuda, n_sel=128,
                               het_words=het_words)
    chip_smoke._check_train_kernel("evaluate_candidates_kernel",
                                   *chip_smoke._eval_call(c), "het words")


@pytest.mark.gpu
@pytest.mark.parametrize("K,C,H,S", [(2, 64, 256, 48), (1, 64, 4096, 8),
                                     (25, 64, 128, 64), (25, 32, 128, 64)])
def test_eval_kernel_identical_candidates(cuda, K, C, H, S):
    """Identical candidates across float4 boundaries
    (chip_smoke.EVAL_TWINS, those below C): bitwise equal counts and
    -2logLik; H=4,096 takes the device-memory plan; K=25, C=32, H=128 is
    the headline step."""
    c = chip_smoke._train_case(np.random.default_rng(40 + H + C), K, C, H,
                               14, S, cuda, twins=chip_smoke.EVAL_TWINS)
    chip_smoke._check_train_kernel("evaluate_candidates_kernel",
                                   *chip_smoke._eval_call(c), "twins",
                                   twins=chip_smoke.EVAL_TWINS)


@pytest.mark.gpu
def test_eval_kernel_plans_agree(cuda):
    """The device-memory plan gives bitwise the default (shared-memory)
    plan's results (chip_smoke._check_eval_plans)."""
    c = chip_smoke._train_case(np.random.default_rng(50), 2, 17, 256, 14, 40,
                               cuda, twins=chip_smoke.EVAL_TWINS)
    assert len(chip_smoke._check_eval_plans(c, "plans")) == 2


@pytest.mark.gpu
def test_train_step_kernels_raise_on_bad_input(cuda):
    c = chip_smoke._train_case(np.random.default_rng(3), 1, 4, 64, 6, 16,
                               cuda)
    em = chip_smoke._em_calls(c)["em_estep"][2]
    with pytest.raises(ValueError, match="one device"):
        ts.em_estep(em[0], em[1], em[2].cpu(), *em[3:])
    with pytest.raises(ValueError, match="EM_H_MULTIPLE"):
        ts.em_estep(em[0][..., :48].contiguous(), em[1][..., :48]
                    .contiguous(), em[2][:, :, :48, :48].contiguous(),
                    *em[3:])
    ev = chip_smoke._eval_call(c)[2]
    with pytest.raises(ValueError, match="one device"):
        ts.evaluate_candidates_kernel(*ev[:6], ev[6].cpu(), *ev[7:])


@pytest.mark.gpu
def test_fused_training_on_the_card(cuda):
    """A small fused training through the kernels: deterministic, launches
    both step kernels, and trains a taggable panel well; hcap=24 is not a
    multiple of 32 and overflows into freeze resumes."""
    from hibag_tpu_torch import predict, train_parallel
    from hibag_tpu_torch.utils.synthetic import synthetic_panel

    (table, geno), (ht, hg) = synthetic_panel(2, 200, 80, 8, n_held_out=60)
    kw = dict(n_classifiers=4, batch=4, seed=1, verbose=False, hcap=24,
              max_steps=60, on_overflow="freeze", with_matching=False,
              device="cuda", mode="fused")
    before = dict(ts.LAUNCHES)
    m1 = train_parallel(table, geno, **kw)
    m2 = train_parallel(table, geno, **kw)
    assert ts.LAUNCHES["em_estep"] > before["em_estep"]
    assert (ts.LAUNCHES["evaluate_candidates_kernel"]
            > before["evaluate_candidates_kernel"])
    for a, b in zip(m1.classifiers, m2.classifiers):
        assert np.array_equal(a.snp_index, b.snp_index)
        assert np.array_equal(a.hap_freq, b.hap_freq)
        assert np.array_equal(a.hap_bits, b.hap_bits)
    assert np.mean([c.oob_accuracy for c in m1.classifiers]) > 0.9
    assert predict(m1, hg, device="cuda").accuracy_vs(ht.allele1,
                                                      ht.allele2) > 0.9
    # the kernels' sums do not depend on the slot capacity, so freezing
    # and resuming at a larger one equals retraining there from scratch
    retry = train_parallel(table, geno, **dict(kw, on_overflow="retry"))
    for a, b in zip(m1.classifiers, retry.classifiers):
        assert np.array_equal(a.snp_index, b.snp_index)
        assert np.array_equal(a.hap_freq, b.hap_freq)


@pytest.fixture(scope="module")
def host_panel():
    from hibag_tpu_torch.utils.synthetic import synthetic_panel
    return synthetic_panel(2, 200, 80, 8, n_held_out=60)


@pytest.mark.gpu
def test_host_training_on_the_card(cuda, host_panel, monkeypatch):
    """train_parallel(mode="host") through the kernels: two runs bitwise
    equal, both step kernels launched, a taggable panel trained well, and
    the first greedy step's EM step and evaluation equal to their plain
    versions on the same CUDA tensors (chip_smoke phase 8's check)."""
    from hibag_tpu_torch import predict, train_parallel
    from hibag_tpu_torch.models import train as train_mod

    (table, geno), (ht, hg) = host_panel
    kw = dict(n_classifiers=3, batch=3, seed=4, verbose=False, mode="host",
              with_matching=False, device="cuda")
    step, first = train_mod.grow_step, []

    def record(*a, **k):
        if not first:
            first.append((a, k))
        return step(*a, **k)

    before = dict(ts.LAUNCHES)
    m1 = train_parallel(table, geno, **kw)
    monkeypatch.setattr(train_mod, "grow_step", record)
    m2 = train_parallel(table, geno, **kw)
    assert ts.LAUNCHES["em_estep"] > before["em_estep"]
    assert (ts.LAUNCHES["evaluate_candidates_kernel"]
            > before["evaluate_candidates_kernel"])
    assert chip_smoke._same_classifiers(m1, m2) == 3
    assert np.mean([c.oob_accuracy for c in m1.classifiers]) > 0.9
    assert predict(m1, hg, device="cuda").accuracy_vs(ht.allele1,
                                                      ht.allele2) > 0.9
    chip_smoke._check_host_step(first[0], "host step 1")


@pytest.mark.gpu
def test_predict_mesh_on_the_card(cuda):
    """predict(devices=["cuda:0", "cuda:0"]): one ensemble-kernel launch per
    shard and block, two calls bitwise equal, calls equal predict()'s on
    one device and postprob at rtol 2e-4."""
    from hibag_tpu_torch import predict
    from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,
                                                 synthetic_model)

    model, pool = synthetic_model(5, n_classifiers=9, n_snp=300, n_alleles=12)
    geno, _, _ = synthetic_cohort(model, pool, 200, 6)
    base = predict(model, geno, device="cuda", with_prob=True)
    mesh = [f"cuda:{cuda.index}"] * 2
    before = ens_acc.LAUNCHES
    r1 = predict(model, geno, devices=mesh, with_prob=True)
    assert ens_acc.LAUNCHES == before + 2
    r2 = predict(model, geno, devices=mesh, with_prob=True)
    for name in ("allele1", "allele2", "prob", "matching", "postprob"):
        assert np.array_equal(getattr(r1, name), getattr(r2, name)), name
    assert np.array_equal(r1.allele1, base.allele1)
    assert np.array_equal(r1.allele2, base.allele2)
    np.testing.assert_allclose(r1.postprob, base.postprob, rtol=2e-4,
                               atol=1e-6)


@pytest.mark.gpu
def test_step_kernels_split_over_classifiers(cuda):
    """The evaluation, int8 EM and packed EM kernels over K=8 are bitwise
    two launches over K=4 (chip_smoke.py phase 11 (c))."""
    chip_smoke._check_batch_split(cuda)


@pytest.mark.gpu
def test_host_training_on_a_mesh_on_the_card(cuda, host_panel):
    """train_parallel(mode="host", mesh=[card, card]) equals the unsharded
    run on the card: SNPs, haplotypes and OOB exactly, frequencies at rtol
    1e-5."""
    from hibag_tpu_torch import train_parallel

    (table, geno), _ = host_panel
    kw = dict(n_classifiers=3, batch=3, seed=4, verbose=False, mode="host",
              with_matching=False)
    one = train_parallel(table, geno, device="cuda", **kw)
    before = dict(ts.LAUNCHES)
    two = train_parallel(table, geno, mesh=[cuda, cuda], **kw)
    assert (ts.LAUNCHES["evaluate_candidates_kernel"]
            > before["evaluate_candidates_kernel"])
    chip_smoke._held_to("host mesh", chip_smoke._classifier_tuples(two),
                        chip_smoke._classifier_tuples(one))


@pytest.mark.gpu
def test_out_of_bag_on_the_card(cuda, host_panel):
    """out_of_bag predicts each classifier's out-of-bag samples through the
    ensemble kernel, and agrees with the plain versions on the CPU."""
    from hibag_tpu_torch import out_of_bag, train_parallel

    (table, geno), _ = host_panel
    model = train_parallel(table, geno, n_classifiers=2, seed=6,
                           verbose=False, with_matching=False, mode="host",
                           device="cuda")
    before = ens_acc.LAUNCHES
    got = out_of_bag(model, table, geno, device="cuda")
    assert ens_acc.LAUNCHES >= before + 2
    want = out_of_bag(model, table, geno, device="cpu")
    assert got["overall"] == want["overall"]
    np.testing.assert_array_equal(got["confusion"], want["confusion"])


@pytest.mark.gpu
@pytest.mark.parametrize("H,A", [(4160, 14), (64, 130), (10016, 14),
                                 (64, 320)])
def test_host_step_past_the_old_limits(cuda, H, A):
    """The host trainer's device step past 4,096 slots or 128 alleles (the
    kernels' limits before they were lifted) launches the EM and evaluation
    kernels, and each agrees with its plain version on the same CUDA
    tensors (chip_smoke._check_host_step: EM at rtol 1e-4, counts exact,
    -2logLik at rtol 1e-4)."""
    from hibag_tpu_torch.models.em import F32_RELTOL
    from hibag_tpu_torch.models.train_fused import grow_step

    rng = np.random.default_rng(7)
    K, C, S = 1, 2, 8
    c = chip_smoke._train_case(rng, K, C, H, A, S, cuda, masks=False)
    args = (c["bits"], c["freq"], c["allele"], c["geno"], c["B"], c["oob"],
            c["gc"], torch.full((K, C), 0.5, device=cuda), c["a1"], c["a2"],
            A, 1e-3, float(S), None, "cuda")
    before = dict(ts.LAUNCHES)
    grow_step(*args, reltol=F32_RELTOL)
    assert (ts.LAUNCHES["em_estep"] + ts.LAUNCHES["em_estep_packed"]
            > before["em_estep"] + before["em_estep_packed"])
    assert (ts.LAUNCHES["evaluate_candidates_kernel"]
            > before["evaluate_candidates_kernel"])
    chip_smoke._check_host_step((args, {"reltol": F32_RELTOL}),
                                f"H={H} A={A}")


@pytest.mark.gpu
def test_wrappers_raise_past_the_real_limits_on_the_card(cuda):
    """Past the real limits each wrapper raises ValueError on CUDA tensors
    and launches nothing: EM past EM_MAX_H slots, the evaluation past
    EVAL_MAX_H slots or EVAL_MAX_A alleles, scoring past MAX_H slots."""
    before = (dict(ts.LAUNCHES), post_scores.LAUNCHES)
    t = lambda *shape: torch.rand(*shape, device=cuda)
    z8 = lambda *shape: torch.zeros(*shape, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="EM_MAX_H"):
        fA = t(1, 2, ts.EM_MAX_H + 32)
        ts.em_estep(fA, fA, z8(1, 1, 32, 32), z8(1, 2, 1), t(1, 1), 1.0)
    N, L = 2, 128
    common = lambda H, A: (
        t(1, H, L).round(), torch.zeros(1, H, dtype=torch.int32, device=cuda),
        t(1, 1, H), t(1, 1, H), z8(1, 1, N), z8(1, N, L),
        torch.zeros(N, dtype=torch.int32, device=cuda),
        torch.zeros(N, dtype=torch.int32, device=cuda),
        torch.zeros(1, N, dtype=torch.bool, device=cuda), t(1, N), A)
    with pytest.raises(ValueError, match="EVAL_MAX_H"):
        ts.evaluate_candidates_kernel(*common(ts.EVAL_MAX_H + 4, 14))
    with pytest.raises(ValueError, match="EVAL_MAX_A"):
        ts.evaluate_candidates_kernel(*common(64, ts.EVAL_MAX_A + 1))
    big = post_scores.MAX_H + 1
    hap = ens_acc.pack_haplotypes(np.zeros((1, big, L), np.uint8),
                                  np.full((1, big), 1.0 / big),
                                  np.zeros((1, big), int), 4, cuda)
    with pytest.raises(ValueError, match="MAX_H"):
        post_scores.ensemble_scores(hap, z8(1, N, L), 4)
    assert (dict(ts.LAUNCHES), post_scores.LAUNCHES) == before


@pytest.mark.gpu
def test_host_float64_on_the_card(cuda, host_panel):
    """train(dtype=np.float64) on the card runs the plain versions in
    float64 (no kernel launches) and gives the CPU's classifier."""
    from hibag_tpu_torch import train

    (table, geno), _ = host_panel
    kw = dict(n_classifiers=1, seed=9, verbose=False, with_matching=False,
              dtype=np.float64)
    before = dict(ts.LAUNCHES)
    got = train(table, geno, device="cuda", **kw).classifiers[0]
    assert ts.LAUNCHES == before
    want = train(table, geno, device="cpu", **kw).classifiers[0]
    np.testing.assert_array_equal(got.snp_index, want.snp_index)
    np.testing.assert_array_equal(got.hap_bits, want.hap_bits)
    np.testing.assert_allclose(got.hap_freq, want.hap_freq, rtol=1e-10)
    assert got.oob_accuracy == want.oob_accuracy


@pytest.mark.gpu
def test_predict_engine_pallas_on_the_card(cuda):
    """engine="pallas" launches the ensemble kernel and "jnp" the scoring
    kernel, with the same calls; "pallas" raises for a model past
    ens_acc.fits (more than MAX_A alleles), before any launch."""
    from hibag_tpu_torch import predict
    from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,
                                                 synthetic_model)

    model, pool = synthetic_model(3, n_classifiers=8, n_snp=300,
                                  n_alleles=20)
    geno, _, _ = synthetic_cohort(model, pool, 64, 4)
    before = (ens_acc.LAUNCHES, post_scores.LAUNCHES)
    a = predict(model, geno, engine="pallas", device="cuda")
    assert ens_acc.LAUNCHES > before[0]
    assert post_scores.LAUNCHES == before[1]
    mid = (ens_acc.LAUNCHES, post_scores.LAUNCHES)
    b = predict(model, geno, engine="jnp", device="cuda")
    assert post_scores.LAUNCHES > mid[1] and ens_acc.LAUNCHES == mid[0]
    assert list(a.allele1) == list(b.allele1)
    np.testing.assert_allclose(a.prob, b.prob, rtol=3e-4)

    wide, wpool = synthetic_model(5, n_classifiers=2, n_snp=120,
                                  n_alleles=ens_acc.MAX_A + 2,
                                  snp_range=(10, 20), hap_range=(140, 160))
    wgeno, _, _ = synthetic_cohort(wide, wpool, 8, 6)
    before = (ens_acc.LAUNCHES, post_scores.LAUNCHES)
    with pytest.raises(ValueError, match="engine='pallas'"):
        predict(wide, wgeno, engine="pallas", device="cuda")
    assert (ens_acc.LAUNCHES, post_scores.LAUNCHES) == before


@pytest.mark.gpu
def test_cli_impute_on_the_card(cuda, tmp_path):
    """`impute` with the default --device cuda launches the ensemble kernel
    and writes the calls of predict(device="cuda")."""
    from hibag_tpu_torch import cli, predict
    from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,
                                                 synthetic_model)

    model, pool = synthetic_model(7, n_classifiers=8, n_snp=300,
                                  n_alleles=20)
    geno, _, _ = synthetic_cohort(model, pool, 40, 8)
    model.save(str(tmp_path / "m.npz"))
    bed = chip_smoke.write_plink(geno, str(tmp_path / "c"))
    before = ens_acc.LAUNCHES
    assert cli.main(["impute", "--model", str(tmp_path / "m.npz"), "--geno",
                     bed, "--out", str(tmp_path / "o.tsv")]) == 0
    assert ens_acc.LAUNCHES > before
    rows = [ln.split("\t") for ln in open(tmp_path / "o.tsv")][1:]
    want = predict(model, geno, device="cuda")
    assert [r[1] for r in rows] == list(want.allele1)
    assert [r[2] for r in rows] == list(want.allele2)
