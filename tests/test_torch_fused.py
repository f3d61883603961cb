"""The port's fused trainer (hibag_tpu_torch.models.train_fused, train.py)
held against hibag_tpu's fused trainer, engine="jnp", on the synthetic
loci of tests/test_fused.py, on the CPU through the kernels' plain
versions."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hibag_tpu
import hibag_tpu_torch
from hibag_tpu.models import train_fused as jfused
from hibag_tpu_torch.models import train_fused as tfused
from hibag_tpu_torch.models.convert import grow_state_from_jax
from hibag_tpu_torch.models.train import TrainingContext
from hibag_tpu_torch.utils.synthetic import synthetic_panel
from tests.test_fused import _synthetic

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _port_ctx(jctx):
    """The port's TrainingContext over the same data as hibag_tpu's."""
    return TrainingContext(
        geno=jctx.geno, a1=jctx.a1, a2=jctx.a2, n_alleles=jctx.n_alleles,
        snp_id=jctx.snp_id, snp_position=jctx.snp_position,
        snp_allele=jctx.snp_allele, sample_id=jctx.sample_id)


def _assert_same(a, b, freq_rtol=1e-4):
    np.testing.assert_array_equal(a.snp_index, b.snp_index)
    np.testing.assert_array_equal(a.hap_allele, b.hap_allele)
    np.testing.assert_array_equal(a.hap_bits, b.hap_bits)
    np.testing.assert_allclose(a.hap_freq, b.hap_freq, rtol=freq_rtol)
    np.testing.assert_array_equal(a.bootstrap_count, b.bootstrap_count)


def test_decide_matches_sequential_scan():
    """tests/test_fused.py::test_decide_matches_sequential_scan for the
    port's batched _decide: 300 randomized cases dense with exact ties, both
    prune modes, fresh and mid-training carries."""
    from hibag_tpu_torch.constants import PRUNE_RELTOL_LOGLIK

    def scan_ref(cand_ok, acc_c, loss_c, gmax_acc, gmin_loss, prune):
        max_acc, min_loss, min_i = gmax_acc, gmin_loss, -1
        kills = []
        for i in range(len(acc_c)):
            ok = bool(cand_ok[i])
            acc = int(acc_c[i])
            loss = float(loss_c[i]) if acc >= max_acc else 0.0
            upd1 = ok and acc > max_acc
            upd2 = ok and not upd1 and acc == max_acc and loss < min_loss
            if upd1 or upd2:
                min_i, min_loss = i, loss
            if upd1:
                max_acc = acc
            kills.append(prune and ok and (
                acc < gmax_acc
                or (acc == gmax_acc
                    and loss > gmin_loss * (1 + PRUNE_RELTOL_LOGLIK)
                    and min_i != i)))
        return min_i, max_acc, min_loss, kills

    rng = np.random.default_rng(0)
    for case in range(300):
        m = int(rng.integers(1, 24))
        acc = rng.integers(0, 4, m).astype(np.int32)
        loss = rng.choice([0.5, 1.0, 1.5, 2.0], m).astype(np.float32)
        ok = rng.random(m) > 0.25
        gmax = int(rng.integers(0, 4))
        gmin = float(rng.choice([1e30, 2.0, 1.0, 0.5]))
        prune = bool(rng.random() > 0.5)
        want = scan_ref(ok, acc, loss, gmax, gmin, prune)
        got = tfused._decide(
            torch.from_numpy(ok)[None], torch.from_numpy(acc)[None],
            torch.from_numpy(loss)[None],
            torch.tensor([gmax], dtype=torch.int32),
            torch.tensor([gmin], dtype=torch.float32), prune)
        assert int(got[0][0]) == want[0], (case, want, got)
        assert int(got[1][0]) == want[1], (case, want, got)
        assert float(got[2][0]) == pytest.approx(want[2]), (case, want, got)
        assert got[3][0].tolist() == want[3], case


# the fixtures of tests/test_fused.py: plain, and overflowing hcap=6
CASES = {
    "seed0": (dict(seed=0), dict(K=3, seed=7, mtry=7, hcap=32,
                                 max_steps=40)),
    "seed5": (dict(seed=5), dict(K=3, seed=13, mtry=7, hcap=32,
                                 max_steps=40)),
    "freeze": (dict(seed=9, n=48, p=64, n_alleles=6),
               dict(K=3, seed=21, mtry=8, hcap=6, max_steps=30,
                    on_overflow="freeze")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_fused_batch_matches_hibag_tpu(case):
    """Same bootstraps, same threefry draws, same decisions: identical SNP
    sequences and haplotype lists, frequencies at float32 tolerance."""
    data, kw = CASES[case]
    jctx = _synthetic(**data)
    want = jfused.train_fused_batch(jctx, engine="jnp", **kw)
    got = tfused.train_fused_batch(_port_ctx(jctx), engine="torch", **kw)
    for a, b in zip(got, want):
        _assert_same(a, b)
        assert a.oob_accuracy == b.oob_accuracy
        assert a.n_snp >= 1


def test_freeze_matches_retry_and_chunked_resume():
    """tests/test_fused.py's freeze tests for the port: freeze equals retry
    (from-scratch retraining at doubled hcap) bitwise, resuming one
    classifier at a time changes nothing, and the resume grew past hcap."""
    import warnings

    ctx = _port_ctx(_synthetic(seed=9, n=48, p=64, n_alleles=6))
    kw = dict(K=3, seed=21, mtry=8, hcap=6, max_steps=30)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        frz = tfused.train_fused_batch(ctx, on_overflow="freeze", **kw)
    assert not [w for w in caught if "hcap" in str(w.message)]
    retry = tfused.train_fused_batch(ctx, on_overflow="retry", **kw)
    chunked = tfused.train_fused_batch(ctx, on_overflow="freeze",
                                       freeze_max_batch=1, **kw)
    for a, b, c in zip(frz, retry, chunked):
        _assert_same(a, b, freq_rtol=0)
        _assert_same(a, c, freq_rtol=0)
        assert a.oob_accuracy == b.oob_accuracy == c.oob_accuracy
        assert a.n_haplo > 6
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tfused.train_fused_batch(ctx, **kw)
    assert [w for w in caught if "hcap" in str(w.message)]


def test_freeze_is_a_noop_without_overflow():
    ctx = _port_ctx(_synthetic(seed=5))
    kw = dict(K=3, seed=13, mtry=7, hcap=32, max_steps=40)
    plain = tfused.train_fused_batch(ctx, **kw)
    frz = tfused.train_fused_batch(ctx, on_overflow="freeze", **kw)
    seg = tfused.train_fused_batch(ctx, seg_steps=4, **kw)
    for a, b, c in zip(plain, frz, seg):
        _assert_same(a, b, freq_rtol=0)
        _assert_same(a, c, freq_rtol=0)


def _jax_setup(jctx, K, seed, hcap):
    """hibag_tpu's train_fused_batch set-up (train_fused.py:575-603)."""
    from hibag_tpu.constants import MAXNUM_SNP
    from hibag_tpu.models.train import _init_haplotype
    from hibag_tpu.utils.rng import RRng

    N = jctx.n_samp
    Bs_real = np.stack([RRng((seed + 1000003 * j) % (2**31 - 1))
                        .bootstrap_counts(N) for j in range(K)])
    Bs = np.stack([jctx.pad_B(b) for b in Bs_real]).astype(np.float32)
    bits0 = np.zeros((K, hcap, MAXNUM_SNP), np.float32)
    freq0 = np.zeros((K, hcap), np.float32)
    allele0 = np.zeros((K, hcap), np.int32)
    for k in range(K):
        st = _init_haplotype(jctx, Bs_real[k])
        freq0[k, :len(st.freq)] = st.freq
        allele0[k, :len(st.freq)] = st.allele
    keys = np.stack([np.asarray(jax.random.PRNGKey(seed * 7919 + j))
                     for j in range(K)])
    state = jfused.GrowState(
        bits=jnp.asarray(bits0), freq=jnp.asarray(freq0),
        allele=jnp.asarray(allele0),
        geno_sel=jnp.full((K, jctx.n_samp_pad, MAXNUM_SNP), 3, jnp.int8),
        n_snp=jnp.zeros(K, jnp.int32),
        snp_order=jnp.full((K, MAXNUM_SNP), -1, jnp.int32),
        pool=jnp.tile(jnp.arange(jctx.n_snp_pad)[None] < jctx.n_snp, (K, 1)),
        gmax_acc=jnp.zeros(K, jnp.int32),
        gmin_loss=jnp.full(K, 1e30, jnp.float32),
        done=jnp.zeros(K, bool), key=jnp.asarray(keys),
        overflow=jnp.zeros(K, jnp.int32), n_step=jnp.zeros(K, jnp.int32),
        steps=jnp.asarray(0, jnp.int32))
    return state, Bs, N


@pytest.mark.parametrize("data_seed,seed", [(0, 7), (5, 13)])
def test_resume_one_step_from_a_hibag_tpu_state(data_seed, seed):
    """Grow two steps in hibag_tpu, carry the state across with
    grow_state_from_jax, and take one more step in both packages.

    (At step 3 of the first case one candidate's OOB count differs: a
    sample's two best allele pairs lie 5e-7 apart, which the float32 EM
    sums, taken in another order, move across; given hibag_tpu's own
    frequencies the port's evaluation gives hibag_tpu's counts. ROADMAP
    queue 3.)"""
    from hibag_tpu.constants import FRACTION_HAPLO, MIN_RARE_FREQ

    jctx = _synthetic(seed=data_seed)
    K, mtry, budget = 3, 7, 40
    state, Bs, N = _jax_setup(jctx, K, seed=seed, hcap=32)
    rare = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)
    real = np.arange(jctx.n_samp_pad) < N
    common = (jnp.asarray(Bs), jnp.asarray(real), jctx.geno_j, jctx.a1_j,
              jctx.a2_j, rare, float(N), jctx.n_alleles, mtry)
    state = jfused.fused_grow_segment(state, jnp.asarray(2, jnp.int32),
                                      jnp.asarray(budget, jnp.int32),
                                      *common, engine="jnp")
    assert int(state.steps) == 2 and not bool(np.asarray(state.done).any())
    host = jfused.GrowState(*(np.asarray(x).copy() for x in state))
    ported = grow_state_from_jax(host, "cpu")
    want = jfused.fused_grow_segment(state, jnp.asarray(3, jnp.int32),
                                     jnp.asarray(budget, jnp.int32),
                                     *common, engine="jnp")

    ctx = _port_ctx(jctx)
    B = torch.from_numpy(Bs)
    is_oob = (B == 0) & torch.from_numpy(real)[None]
    got = tfused._step(ported, B, is_oob, ctx.geno_t.T.contiguous(),
                       ctx.a1_t, ctx.a2_t, rare, float(N), ctx.n_alleles,
                       mtry, True, False, budget, None, "torch")
    assert got.steps == int(want.steps) == 3
    assert bool((got.n_snp.numpy() > host.n_snp).any())
    for name in ("bits", "allele", "geno_sel", "n_snp", "snp_order", "pool",
                 "gmax_acc", "done", "key", "overflow", "n_step"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(),
            np.asarray(getattr(want, name)).astype(
                getattr(got, name).numpy().dtype), err_msg=name)
    np.testing.assert_allclose(got.freq.numpy(), np.asarray(want.freq),
                               rtol=1e-4)
    # -2 sum B log(post): where post is within float32 resolution of 1 each
    # of the N bootstrap draws carries an absolute error of ~2 ulp(1)
    np.testing.assert_allclose(got.gmin_loss.numpy(),
                               np.asarray(want.gmin_loss), rtol=1e-4,
                               atol=4 * N * 2.0**-23)


@pytest.fixture(scope="module")
def panel():
    """A typed synthetic panel and held-out samples of the same pool."""
    return synthetic_panel(1, 96, 60, 6, n_held_out=40)


def test_train_parallel_end_to_end(panel, tmp_path):
    """train_parallel(mode="fused") on the CPU: the same classifiers as
    hibag_tpu's fused train_parallel; the model, saved to .npz and loaded by
    hibag_tpu, gives the same calls in both packages' predict."""
    (table, geno), (htable, hgeno) = panel
    kw = dict(n_classifiers=4, batch=2, seed=3, verbose=False, hcap=32,
              max_steps=40, on_overflow="freeze", mode="fused")
    model = hibag_tpu_torch.train_parallel(table, geno, device="cpu", **kw)
    jtable = hibag_tpu.HLATypeTable.from_alleles(
        table.sample_id, table.allele1, table.allele2, locus="A")
    jgeno = hibag_tpu.SNPGenoData(
        genotype=geno.genotype, sample_id=geno.sample_id, snp_id=geno.snp_id,
        snp_position=geno.snp_position, snp_allele=geno.snp_allele,
        assembly=geno.assembly)
    jmodel = hibag_tpu.train_parallel(jtable, jgeno, engine="jnp", **kw)
    assert len(model.classifiers) == 4
    for a, b in zip(model.classifiers, jmodel.classifiers):
        _assert_same(a, b)
    np.testing.assert_allclose(model.matching, jmodel.matching, rtol=1e-3)
    assert np.mean([c.oob_accuracy for c in model.classifiers]) > 0.9

    path = str(tmp_path / "trained.npz")
    model.save(path)
    loaded = hibag_tpu.AttrBagModel.load(path)
    jh = hibag_tpu.SNPGenoData(
        genotype=hgeno.genotype, sample_id=hgeno.sample_id,
        snp_id=hgeno.snp_id, snp_position=hgeno.snp_position,
        snp_allele=hgeno.snp_allele, assembly=hgeno.assembly)
    r = hibag_tpu_torch.predict(model, hgeno, device="cpu")
    j = hibag_tpu.predict(loaded, jh)
    np.testing.assert_array_equal(r.allele1, j.allele1)
    np.testing.assert_array_equal(r.allele2, j.allele2)
    np.testing.assert_allclose(r.prob, j.prob, rtol=3e-4)
    assert r.accuracy_vs(htable.allele1, htable.allele2) > 0.9


def test_train_parallel_batches_and_unported_mode(panel, tmp_path):
    """The batch size does not change the classifiers (each id fixes its
    bootstrap and draws); auto_save + resume continues a partial run;
    mode="host" trains too (tests/test_torch_train.py holds it against
    hibag_tpu)."""
    (table, geno), _ = panel
    kw = dict(n_classifiers=3, seed=5, verbose=False, hcap=32, max_steps=40,
              with_matching=False, device="cpu", mode="fused")
    one = hibag_tpu_torch.hlaParallelAttrBagging(table, geno, batch=3, **kw)
    path = str(tmp_path / "partial.npz")
    first = hibag_tpu_torch.train_parallel(
        table, geno, batch=1, auto_save=path, **dict(kw, n_classifiers=1))
    assert len(first.classifiers) == 1
    resumed = hibag_tpu_torch.train_parallel(
        table, geno, batch=1, auto_save=path, resume=True, **kw)
    for a, b in zip(one.classifiers, resumed.classifiers):
        _assert_same(a, b, freq_rtol=0)
    host = hibag_tpu_torch.train_parallel(table, geno,
                                          **dict(kw, mode="host"))
    assert len(host.classifiers) == 3
    assert all(c.n_snp >= 1 for c in host.classifiers)
    with pytest.raises(ValueError, match="engine"):
        hibag_tpu_torch.train_parallel(table, geno, engine="cuda", **kw)


def test_synthetic_panel_mosaic():
    """recombination=0 keeps the pool's haplotypes; above 0 each haplotype
    keeps its own at the middle SNP, copies it less with distance from
    there, switches at the given rate per megabase, and the panel holds
    many more distinct haplotypes."""
    from hibag_tpu_torch.utils import synthetic

    rng = np.random.default_rng(0)
    pool = synthetic._haplotype_pool(rng, 201, 6, 3, 0.02)
    idx = rng.choice(len(pool.freq), 400, p=pool.freq)
    np.testing.assert_array_equal(synthetic._mosaic(rng, pool, idx, 0.0),
                                  pool.bits[idx])
    bits = synthetic._mosaic(rng, pool, idx, 0.05)
    same = (bits == pool.bits[idx]).mean(0)
    assert same[100] == 1.0
    assert same[90:111].mean() > 0.9 > 0.7 > same[:20].mean()
    assert len(np.unique(bits, axis=0)) > 5 * len(np.unique(pool.bits[idx],
                                                             axis=0))
    pos = np.sort(rng.choice(np.arange(1_000_000), 201, replace=False))
    p = synthetic._switch_prob(pos, 10.0)
    assert p[100] == 0.0 and bool(((p > 0) & (p < 1)).sum() == 200)
    assert p.sum() == pytest.approx(10.0 * (pos[-1] - pos[0]) / 1e6,
                                    rel=0.05)
    (_, g0), _ = synthetic_panel(1, 96, 60, 6)
    (_, g1), _ = synthetic_panel(1, 96, 60, 6, recombination=10.0)
    assert len(np.unique(g1.genotype.T, axis=0)) > len(
        np.unique(g0.genotype.T, axis=0))
