"""hibag_tpu_torch.models.em (the training-step math, plain PyTorch) held
against hibag_tpu.models.em on the same seeded inputs. The port batches a
leading classifier axis K where the JAX module is vmapped; these tests put
one classifier, or a batch of two, through both."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibag_tpu.models import em as ref
from hibag_tpu_torch.models import em as port

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _problem(seed=0, N=24, H=128, L=128, Cm=9, A=6, n_sel=20,
             typed=False):
    """tests/test_step_pallas.py::_rand_problem with the unselected SNP
    columns missing (code 3), as the trainer keeps them. With `typed`, each
    sample carries two of the first 20 haplotypes (5% of codes missing) and
    their alleles, as a training panel does; otherwise its codes and
    alleles are drawn independently."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (H, L)).astype(np.float32)
    freq = rng.random(H).astype(np.float32)
    freq[40:] = 0
    freq /= freq.sum()
    allele = np.sort(rng.integers(0, A, H)).astype(np.int32)
    geno_sel = np.full((N, L), 3, np.int8)
    geno_sel[:, :n_sel] = rng.integers(0, 4, (N, n_sel))
    a12 = np.sort(rng.integers(0, A, (2, N)), 0).astype(np.int32)
    if typed:
        pair = rng.integers(0, 20, (2, N))
        geno_sel[:, :n_sel] = (bits[pair[0], :n_sel]
                               + bits[pair[1], :n_sel]).astype(np.int8)
        geno_sel[:, :n_sel][rng.random((N, n_sel)) < 0.05] = 3
        a12 = np.sort(allele[pair], 0).astype(np.int32)
    B = rng.multinomial(N, np.ones(N) / N).astype(np.float32)
    g_cand = rng.integers(0, 4, (Cm, N)).astype(np.int8)
    fA = (np.abs(rng.normal(0, .1, (Cm, H))) * (freq > 0)).astype(np.float32)
    fB = (np.abs(rng.normal(0, .1, (Cm, H))) * (freq > 0)).astype(np.float32)
    return dict(bits=bits, freq=freq, valid=freq > 0, allele=allele,
                geno_sel=geno_sel, a1=a12[0], a2=a12[1], B=B, g_cand=g_cand,
                fA=fA, fB=fB, A=A)


def _t(x, k=True):
    """numpy -> torch, with a leading classifier axis of 1 when `k`."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t[None] if k else t


def _match_args(p, jax_side):
    if jax_side:
        return tuple(jnp.asarray(p[n]) for n in
                     ("bits", "valid", "allele", "geno_sel", "a1", "a2"))
    return (_t(p["bits"]), _t(p["valid"]), _t(p["allele"]),
            _t(p["geno_sel"]), _t(p["a1"], False), _t(p["a2"], False))


@pytest.mark.parametrize("seed,N,variant", [
    pytest.param(0, 24, None, id="0-24"),
    pytest.param(1, 300, None, id="1-300"),
    pytest.param(2, 64, "typed", id="2-64-typed"),
    pytest.param(3, 48, "empty block", id="3-48-empty-block"),
    pytest.param(4, 48, "a1 == a2", id="4-48-same-alleles"),
    pytest.param(5, 48, "all missing", id="5-48-all-missing")])
def test_match_pairs_and_packed_masks_equal(seed, N, variant):
    # N=300 at H=128 takes two sample chunks on both sides; the variants
    # name engine="torch" (the plain version the matching kernel is held
    # against) and give samples an allele no slot carries, both alleles
    # equal, or no called genotype (every block pair ties)
    p = _problem(seed, N=N, typed=variant is not None)
    kw = {} if variant is None else {"engine": "torch"}
    if variant == "empty block":
        p["a2"][::5] = p["A"] + 1
    elif variant == "a1 == a2":
        p["a2"] = p["a1"].copy()
    elif variant == "all missing":
        p["geno_sel"][::4] = 3
    mask = np.asarray(ref.match_pairs(*_match_args(p, True)))
    packed = np.asarray(ref.match_pairs_packed(*_match_args(p, True)))
    np.testing.assert_array_equal(
        port.match_pairs(*_match_args(p, False), **kw)[0].numpy(), mask)
    np.testing.assert_array_equal(
        port.match_pairs_packed(*_match_args(p, False), **kw)[0].numpy(),
        packed)
    assert mask.any()
    unpacked = port._unpack_mask(torch.from_numpy(packed.copy()),
                                 torch.float32)
    np.testing.assert_array_equal(unpacked.numpy(), mask.astype(np.float32))


def test_geno_sel_masks_equal():
    g = np.random.default_rng(3).integers(0, 4, (5, 40)).astype(np.int8)
    np.testing.assert_array_equal(
        port._geno_sel_masks(torch.from_numpy(g), torch.float32).numpy(),
        np.asarray(ref._geno_sel_masks(jnp.asarray(g), jnp.float32)))


def test_em_estep_chunk_matches():
    p = _problem(2)
    mask = ref.match_pairs(*_match_args(p, True))
    m = ref._geno_sel_masks(jnp.asarray(p["g_cand"]), jnp.float32)
    want = ref._em_estep_chunk(jnp.asarray(p["fA"]), jnp.asarray(p["fB"]),
                               mask.astype(jnp.float32), jnp.asarray(p["B"]),
                               m, 24.0)
    got = port._em_estep_chunk(
        _t(p["fA"]), _t(p["fB"]), _t(np.asarray(mask, np.float32)),
        _t(p["B"]), _t(np.asarray(m)), 24.0)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x[0].numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("tier", ["int8", "packed", "remat"])
def test_estep_tiers_match(tier):
    """Each mask tier of the port's _make_estep against hibag_tpu's masked
    E-step, over two classifiers with their own masks and weights."""
    ps = [_problem(10 + k, N=200) for k in range(2)]
    S, H = 200, 128
    budget = {"int8": S * H * H, "packed": S * H * H // 8, "remat": 0}[tier]
    st = lambda name: torch.from_numpy(np.stack([p[name] for p in ps]))
    estep = port._make_estep(st("valid"), st("bits"), st("allele"),
                             st("geno_sel"), _t(ps[0]["a1"], False),
                             _t(ps[0]["a2"], False), st("B"), st("g_cand"),
                             24.0, mask_budget=budget)
    got = estep(st("fA"), st("fB"))
    for k, p in enumerate(ps):
        p = dict(p, a1=ps[0]["a1"], a2=ps[0]["a2"])
        mask = ref.match_pairs(*_match_args(p, True))
        m = ref._geno_sel_masks(jnp.asarray(p["g_cand"]), jnp.float32)
        want = ref._em_estep_masked(jnp.asarray(p["fA"]), jnp.asarray(p["fB"]),
                                    mask, jnp.asarray(p["B"]), m, 24.0)
        for x, y in zip(got, want):
            np.testing.assert_allclose(x[k].numpy(), np.asarray(y),
                                       rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("budget", [None, 0])
def test_em_all_candidates_matches(budget):
    p = _problem(4, Cm=7)
    afreq = np.random.default_rng(5).uniform(0.1, 0.9, 7).astype(np.float32)
    fA_r, fB_r, ll_r, it_r = ref.em_all_candidates(
        jnp.asarray(p["freq"]), jnp.asarray(p["valid"]),
        jnp.asarray(p["bits"]), jnp.asarray(p["allele"]),
        jnp.asarray(p["geno_sel"]), jnp.asarray(p["a1"]), jnp.asarray(p["a2"]),
        jnp.asarray(p["B"]), jnp.asarray(p["g_cand"]), jnp.asarray(afreq),
        24.0)
    fA, fB, ll, it = port.em_all_candidates(
        _t(p["freq"]), _t(p["valid"]), _t(p["bits"]), _t(p["allele"]),
        _t(p["geno_sel"]), _t(p["a1"], False), _t(p["a2"], False), _t(p["B"]),
        _t(p["g_cand"]), _t(afreq), 24.0, mask_budget=budget)
    assert int(it[0]) == int(it_r) > 2
    np.testing.assert_allclose(fA[0].numpy(), np.asarray(fA_r), rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(fB[0].numpy(), np.asarray(fB_r), rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(ll[0].numpy(), np.asarray(ll_r), rtol=1e-4)


def test_em_all_candidates_per_classifier_iterations():
    """Two classifiers that converge after different numbers of iterations:
    each keeps its own count and state, as under hibag_tpu's vmap; a skipped
    (done) classifier stops after the first step."""
    ps = [_problem(20, Cm=5), _problem(21, Cm=5)]
    afreq = np.full((2, 5), 0.4, np.float32)
    st = lambda name: torch.from_numpy(np.stack([p[name] for p in ps]))
    a1, a2 = _t(ps[0]["a1"], False), _t(ps[0]["a2"], False)
    fA, fB, ll, it = port.em_all_candidates(
        st("freq"), st("valid"), st("bits"), st("allele"), st("geno_sel"),
        a1, a2, st("B"), st("g_cand"), torch.from_numpy(afreq), 24.0)
    for k, p in enumerate(ps):
        want = ref.em_all_candidates(
            jnp.asarray(p["freq"]), jnp.asarray(p["valid"]),
            jnp.asarray(p["bits"]), jnp.asarray(p["allele"]),
            jnp.asarray(p["geno_sel"]), jnp.asarray(ps[0]["a1"]),
            jnp.asarray(ps[0]["a2"]), jnp.asarray(p["B"]),
            jnp.asarray(p["g_cand"]), jnp.asarray(afreq[k]), 24.0)
        assert int(it[k]) == int(want[3])
        np.testing.assert_allclose(fA[k].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(ll[k].numpy(), np.asarray(want[2]),
                                   rtol=1e-4)
    skipped = port.em_all_candidates(
        st("freq"), st("valid"), st("bits"), st("allele"), st("geno_sel"),
        a1, a2, st("B"), st("g_cand"), torch.from_numpy(afreq), 24.0,
        skip=torch.tensor([True, False]))
    assert int(skipped[3][0]) == 1 and int(skipped[3][1]) == int(it[1])
    np.testing.assert_array_equal(skipped[0][1].numpy(), fA[1].numpy())


def test_erase_rare_exact():
    rng = np.random.default_rng(6)
    fA = rng.random((2, 5, 64)).astype(np.float32) * 1e-2
    fB = rng.random((2, 5, 64)).astype(np.float32) * 1e-2
    fA[rng.random(fA.shape) < 0.3] = 1e-7   # rare
    fB[rng.random(fB.shape) < 0.3] = 2e-6   # rare
    fA[0, 0, :4] = fB[0, 0, :4]             # keep_bit0 on ties
    fA[1, 1, :] = 0.0
    fB[1, 1, :] = 0.0                       # all dropped: no division by 0
    got = port.erase_rare(torch.from_numpy(fA), torch.from_numpy(fB), 1e-3)
    for k in range(2):
        want = ref.erase_rare(jnp.asarray(fA[k]), jnp.asarray(fB[k]), 1e-3)
        for x, y in zip(got, want):
            # which slots are kept, merged or dropped is exact; the
            # renormalising sum is a float32 reduction in each library's
            # own order
            y = np.asarray(y)
            np.testing.assert_array_equal(x[k].numpy() == 0, y == 0)
            np.testing.assert_allclose(x[k].numpy(), y, rtol=1e-6)


@pytest.mark.parametrize("seed,N,H,typed", [(1, 24, 128, False),
                                            (7, 200, 64, True)])
def test_evaluate_candidates_matches(seed, N, H, typed):
    """Untyped samples put many true pairs far from every haplotype pair,
    where the true pair's posterior underflows, so the large case is typed,
    as a training panel is."""
    rng = np.random.default_rng(seed + 100)
    p = _problem(seed, N=N, H=H, typed=typed)
    # post-erase frequencies: per-candidate dropped rows (typed: not the
    # samples' own haplotypes, which a real erase keeps)
    drop = rng.random((2, *p["fA"].shape)) < 0.3
    if typed:
        drop[..., :20] = False
    fA = np.where(drop[0], 0, p["fA"]).astype(np.float32)
    fB = np.where(drop[1], 0, p["fB"]).astype(np.float32)
    is_oob = p["B"] == 0
    acc_r, ll_r = ref.evaluate_candidates(
        jnp.asarray(p["bits"]), jnp.asarray(p["allele"]), jnp.asarray(10),
        jnp.asarray(fA), jnp.asarray(fB), jnp.asarray(p["g_cand"]),
        jnp.asarray(p["geno_sel"]), jnp.asarray(p["a1"]), jnp.asarray(p["a2"]),
        jnp.asarray(is_oob), jnp.asarray(p["B"]), p["A"])
    acc, ll = port.evaluate_candidates(
        _t(p["bits"]), _t(p["allele"]), _t(fA), _t(fB), _t(p["g_cand"]),
        _t(p["geno_sel"]), _t(p["a1"], False), _t(p["a2"], False),
        _t(is_oob), _t(p["B"]), p["A"])
    assert int(np.asarray(acc_r).sum()) > 0
    np.testing.assert_array_equal(acc[0].numpy(), np.asarray(acc_r))
    np.testing.assert_allclose(ll[0].numpy(), np.asarray(ll_r), rtol=1e-4)


@pytest.mark.parametrize("seed,N,H", [(3, 400, 64), (4, 200, 128),
                                      (5, 200, 64), (6, 300, 64),
                                      (7, 200, 64), (2, 200, 64)])
def test_evaluate_candidates_denormal_rule(seed, N, H):
    """Untyped samples, whose true-pair scores can be sums of denormal
    terms: the plain evaluation flushes denormals inside its sums as XLA
    does for hibag_tpu (and counts a sum below FLT_MIN as 0), so counts
    are exact and -2logLik agrees at rtol 1e-4."""
    rng = np.random.default_rng(seed + 100)
    p = _problem(seed, N=N, H=H)
    drop = rng.random((2, *p["fA"].shape)) < 0.3
    fA = np.where(drop[0], 0, p["fA"]).astype(np.float32)
    fB = np.where(drop[1], 0, p["fB"]).astype(np.float32)
    is_oob = p["B"] == 0
    acc_r, ll_r = ref.evaluate_candidates(
        jnp.asarray(p["bits"]), jnp.asarray(p["allele"]), jnp.asarray(10),
        jnp.asarray(fA), jnp.asarray(fB), jnp.asarray(p["g_cand"]),
        jnp.asarray(p["geno_sel"]), jnp.asarray(p["a1"]), jnp.asarray(p["a2"]),
        jnp.asarray(is_oob), jnp.asarray(p["B"]), p["A"])
    acc, ll, tq, _ = port.evaluate_candidates(
        _t(p["bits"]), _t(p["allele"]), _t(fA), _t(fB), _t(p["g_cand"]),
        _t(p["geno_sel"]), _t(p["a1"], False), _t(p["a2"], False),
        _t(is_oob), _t(p["B"]), p["A"], per_sample=True)
    assert not bool(((tq > 0) & (tq < np.finfo(np.float32).tiny)).any())
    np.testing.assert_array_equal(acc[0].numpy(), np.asarray(acc_r))
    np.testing.assert_allclose(ll[0].numpy(), np.asarray(ll_r), rtol=1e-4)


@pytest.mark.parametrize("caller", [False, True])
def test_evaluate_candidates_restores_the_flush_setting(caller):
    """The plain evaluation flushes denormals while it runs and leaves the
    caller's setting as it found it, on or off."""
    p = _problem(5, N=16)
    args = (_t(p["bits"]), _t(p["allele"]), _t(p["fA"]), _t(p["fB"]),
            _t(p["g_cand"]), _t(p["geno_sel"]), _t(p["a1"], False),
            _t(p["a2"], False), _t(p["B"] == 0), _t(p["B"]), p["A"])
    threads = torch.get_num_threads()
    assert torch.set_flush_denormal(caller)
    try:
        assert port._flushing() == caller
        port.evaluate_candidates(*args)
        assert port._flushing() == caller
        with port.flush_denormals():
            assert port._flushing() and torch.get_num_threads() == 1
        assert port._flushing() == caller
        assert torch.get_num_threads() == threads
    finally:
        torch.set_flush_denormal(False)


def test_evaluate_candidates_per_sample():
    """per_sample=True adds each sample's true-pair score and total, from
    which -2logLik is summed, and leaves the other results as they are."""
    p = _problem(3, N=40, typed=True)
    is_oob = p["B"] == 0
    args = (_t(p["bits"]), _t(p["allele"]), _t(p["fA"]), _t(p["fB"]),
            _t(p["g_cand"]), _t(p["geno_sel"]), _t(p["a1"], False),
            _t(p["a2"], False), _t(is_oob), _t(p["B"]), p["A"])
    acc, ll = port.evaluate_candidates(*args)
    acc2, ll2, tq, total = port.evaluate_candidates(*args, per_sample=True)
    assert torch.equal(acc, acc2) and torch.equal(ll, ll2)
    assert tq.shape == total.shape == (1, 9, 40)
    assert bool((tq <= total * (1 + 1e-6)).all())
    post = (tq / total.clamp_min(1e-37)).clamp_min(1e-37)
    want = -2.0 * (_t(p["B"])[:, None] * torch.log(post)).sum(-1)
    torch.testing.assert_close(ll, want, rtol=1e-6, atol=0)
