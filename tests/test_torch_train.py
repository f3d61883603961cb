"""The port's host trainer (hibag_tpu_torch.models.train: SamplingWithoutReplace,
grow_classifier, train_parallel_batch, train_parallel(mode="host"), train)
held against hibag_tpu's on seeded mosaic synthetic panels, on the CPU
through the kernels' plain versions."""

import os

import jax
import numpy as np
import pytest
import torch

import hibag_tpu
import hibag_tpu_torch
from hibag_tpu.models import train as jtrain
from hibag_tpu.utils.rng import RRng as JRng
from hibag_tpu_torch.models import train as ttrain
from hibag_tpu_torch.utils.rng import RRng
from hibag_tpu_torch.utils.synthetic import synthetic_panel

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _jax_data(table, geno):
    """hibag_tpu's HLATypeTable and SNPGenoData over the same arrays."""
    jtable = hibag_tpu.HLATypeTable.from_alleles(
        table.sample_id, table.allele1, table.allele2, locus=table.locus)
    jgeno = hibag_tpu.SNPGenoData(
        genotype=geno.genotype, sample_id=geno.sample_id, snp_id=geno.snp_id,
        snp_position=geno.snp_position, snp_allele=geno.snp_allele,
        assembly=geno.assembly)
    return jtable, jgeno


@pytest.fixture(scope="module")
def panel():
    """A typed mosaic panel: 96 samples, 60 SNPs, 6 alleles; classifiers
    of 37-66 haplotypes."""
    (table, geno), _ = synthetic_panel(1, 96, 60, 6, recombination=10.0)
    return (table, geno), _jax_data(table, geno)


def _contexts(panel, hap_bucket=32):
    (table, geno), (jtable, jgeno) = panel
    jctx, _, _ = jtrain.make_training_context(jtable, jgeno,
                                              hap_bucket=hap_bucket)
    tctx, _, _ = ttrain.make_training_context(table, geno,
                                              hap_bucket=hap_bucket,
                                              device="cpu")
    assert tctx.hap_bucket == hap_bucket
    return jctx, tctx, int(np.ceil(np.sqrt(jctx.n_snp)))


def _assert_same(a, b, freq_rtol):
    np.testing.assert_array_equal(a.snp_index, b.snp_index)
    np.testing.assert_array_equal(a.hap_bits, b.hap_bits)
    np.testing.assert_array_equal(a.hap_allele, b.hap_allele)
    np.testing.assert_array_equal(a.bootstrap_count, b.bootstrap_count)
    np.testing.assert_allclose(a.hap_freq, b.hap_freq, rtol=freq_rtol)
    assert a.oob_accuracy == b.oob_accuracy
    assert a.n_snp >= 1


def _assert_same_rng(jr, tr):
    np.testing.assert_array_equal(jr.mt, tr.mt)
    assert jr.mti == tr.mti


def test_sampling_without_replace_matches_hibag_tpu():
    """A seeded sequence of selections, removals and flags leaves the same
    pool, selection and RNG state in both packages."""
    ops = np.random.default_rng(0)
    want, got = jtrain.SamplingWithoutReplace(40), \
        ttrain.SamplingWithoutReplace(40)
    jr, tr = JRng(11), RRng(11)
    for _ in range(30):
        if want.total() == 0:
            break
        m = int(ops.integers(1, 12))
        want.random_select(m, jr)
        got.random_select(m, tr)
        assert got.selection() == want.selection()
        op = int(ops.integers(0, 3))
        if op == 0:
            i = int(ops.integers(0, want.m_try))
            want.remove(i)
            got.remove(i)
        elif op == 1:
            want.remove_selection()
            got.remove_selection()
        else:
            for i in ops.choice(want.m_try, (want.m_try + 1) // 2,
                                replace=False):
                want.set_selected(int(i), -1)
                got.set_selected(int(i), -1)
            want.remove_flagged()
            got.remove_flagged()
        assert got.idx == want.idx and got.m_try == want.m_try
        _assert_same_rng(jr, tr)


@pytest.mark.parametrize("hap_bucket", [32, 8])
@pytest.mark.parametrize("seed", [1, 2])
def test_grow_classifier_matches_hibag_tpu(panel, hap_bucket, seed):
    """Same bootstrap and R RNG stream: the same SNP sequence, haplotypes,
    alleles and OOB accuracy, frequencies at float32 tolerance, and the
    stream left in the same state."""
    jctx, tctx, mtry = _contexts(panel, hap_bucket)
    jr, tr = JRng(seed), RRng(seed)
    B = jr.bootstrap_counts(jctx.n_samp)
    np.testing.assert_array_equal(tr.bootstrap_counts(tctx.n_samp), B)
    want = jtrain.grow_classifier(jctx, B, jr, mtry)
    got = ttrain.grow_classifier(tctx, B, tr, mtry, em_iter_seg=2)
    _assert_same(got, want, freq_rtol=1e-4)
    assert got.n_haplo > 20
    _assert_same_rng(jr, tr)


@pytest.mark.parametrize("seed", [1, 2])
def test_grow_classifier_float64_matches_hibag_tpu(panel, seed):
    """dtype=np.float64: the plain versions in float64 against hibag_tpu's
    float64 path (inside a local enable_x64, which does not leak to other
    tests of the worker)."""
    jctx, tctx, mtry = _contexts(panel)
    jr, tr = JRng(seed), RRng(seed)
    B = jr.bootstrap_counts(jctx.n_samp)
    tr.bootstrap_counts(tctx.n_samp)
    with jax.enable_x64(True):
        want = jtrain.grow_classifier(jctx, B, jr, mtry, dtype=np.float64)
    got = ttrain.grow_classifier(tctx, B, tr, mtry, dtype=np.float64)
    _assert_same(got, want, freq_rtol=1e-10)
    _assert_same_rng(jr, tr)
    with pytest.raises(ValueError, match="float64"):
        ttrain.grow_classifier(tctx, B, RRng(seed), mtry, dtype=np.float64,
                               engine="cuda")


def _native_ordered():
    from hibag_tpu_torch.io.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "hibag_ordered_step"):
        pytest.skip("the native library (make -C native) is not built")


def test_ordered_step_matches_hibag_tpu():
    """io/native.py::ordered_step gives bitwise hibag_tpu's results on a
    seeded step (24 haplotypes of 4 alleles over 5 SNPs, 8 candidates)."""
    _native_ordered()
    from hibag_tpu.io.native import ordered_step as jordered
    from hibag_tpu_torch.io.native import ordered_step

    rng = np.random.default_rng(4)
    H, n_snp, C, N, A = 24, 5, 8, 40, 4
    bits = rng.integers(0, 2, (H, n_snp), dtype=np.uint8)
    freq = rng.dirichlet(np.ones(H))
    allele = np.sort(rng.integers(0, A, H)).astype(np.int32)
    a = np.sort(rng.choice(allele, (N, 2)), axis=1).astype(np.int32)
    geno_sel = np.full((N, 128), 3, dtype=np.int8)
    geno_sel[:, :n_snp] = rng.integers(0, 4, (N, n_snp))
    g_cand = rng.integers(0, 4, (C, N)).astype(np.int8)
    B = rng.multinomial(N, np.ones(N) / N).astype(np.float64)
    args = (bits, freq, allele, g_cand, geno_sel, a[:, 0], a[:, 1], B == 0,
            B, A, float(N), 1e-3)
    want, got = jordered(*args), ordered_step(*args)
    assert got[0].any() and got[4].min() > 0
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [1, 3])
def test_grow_classifier_ordered_matches_hibag_tpu(panel, seed):
    """eval_mode="ordered" (the reference's serial sums, on the host): the
    classifier bitwise equal to hibag_tpu's."""
    _native_ordered()
    jctx, tctx, mtry = _contexts(panel)
    jr, tr = JRng(seed), RRng(seed)
    B = jr.bootstrap_counts(jctx.n_samp)
    tr.bootstrap_counts(tctx.n_samp)
    want = jtrain.grow_classifier(jctx, B, jr, mtry, eval_mode="ordered")
    got = ttrain.grow_classifier(tctx, B, tr, mtry, eval_mode="ordered")
    _assert_same(got, want, freq_rtol=0)
    _assert_same_rng(jr, tr)


def test_train_parallel_host_matches_hibag_tpu(panel):
    """train_parallel(mode="host"): hibag_tpu's classifiers; a batch of 1
    gives bitwise the batch of 4's; mode="auto" on the CPU trains host."""
    (table, geno), (jtable, jgeno) = panel
    kw = dict(n_classifiers=4, seed=3, verbose=False, with_matching=False)
    want = hibag_tpu.train_parallel(jtable, jgeno, mode="host", batch=4,
                                    **kw)
    got = hibag_tpu_torch.train_parallel(table, geno, mode="host", batch=4,
                                         device="cpu", **kw)
    one = hibag_tpu_torch.train_parallel(table, geno, mode="host", batch=1,
                                         device="cpu", **kw)
    auto = hibag_tpu_torch.train_parallel(table, geno, batch=3,
                                          device="cpu", **kw)
    for a, b, c, d in zip(got.classifiers, want.classifiers,
                          one.classifiers, auto.classifiers):
        _assert_same(a, b, freq_rtol=1e-4)
        _assert_same(a, c, freq_rtol=0)
        _assert_same(a, d, freq_rtol=0)


def test_train_matches_hibag_tpu(panel):
    """train() (hlaAttrBagging): the classifiers of one R RNG stream, and
    the model's matching proportions."""
    (table, geno), (jtable, jgeno) = panel
    kw = dict(n_classifiers=2, seed=5, verbose=False)
    want = hibag_tpu.train(jtable, jgeno, **kw)
    got = hibag_tpu_torch.hlaAttrBagging(table, geno, device="cpu", **kw)
    assert len(got.classifiers) == 2
    for a, b in zip(got.classifiers, want.classifiers):
        _assert_same(a, b, freq_rtol=1e-4)
    np.testing.assert_allclose(got.matching, want.matching, rtol=1e-3)
    np.testing.assert_array_equal(got.sample_id, want.sample_id)


def test_host_trainer_arguments(panel):
    """hap_bucket= reaches the context; a mesh= that is neither an
    EnsembleMesh nor a list of devices raises TypeError; unknown modes,
    dtypes and eval modes raise."""
    (table, geno), _ = panel
    _, tctx, mtry = _contexts(panel, hap_bucket=16)
    kw = dict(n_classifiers=1, verbose=False, with_matching=False,
              device="cpu")
    with pytest.raises(TypeError, match="list of devices"):
        hibag_tpu_torch.train_parallel(table, geno, mesh=object(), **kw)
    with pytest.raises(TypeError, match="list of devices"):
        ttrain.train_parallel_batch(tctx, [RRng(1)], mtry, mesh=object())
    with pytest.raises(ValueError, match="mode"):
        hibag_tpu_torch.train_parallel(table, geno, mode="mesh", **kw)
    B = RRng(1).bootstrap_counts(tctx.n_samp)
    with pytest.raises(ValueError, match="dtype"):
        ttrain.grow_classifier(tctx, B, RRng(1), mtry, dtype=np.float16)
    with pytest.raises(ValueError, match="eval_mode"):
        ttrain.grow_classifier(tctx, B, RRng(1), mtry, eval_mode="exact")
    m = hibag_tpu_torch.train_parallel(table, geno, hap_bucket=16,
                                       mode="host", **kw)
    assert len(m.classifiers) == 1
