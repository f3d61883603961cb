"""The training-step and scoring kernels' shapes past 4,096 haplotype slots
and 128 alleles, on the CPU: their plain versions (which the wrappers run
for a CPU tensor) held against hibag_tpu's jnp EM step and candidate
evaluation on the same seeded inputs, and the planners that choose where
each CUDA kernel keeps its data at those shapes. The kernels themselves are
held against the plain versions at these shapes on the card
(tests/test_torch_gpu.py, chip_smoke.py's [limits] phase)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibag_tpu.models import em as ref
from hibag_tpu_torch.models import em
from hibag_tpu_torch.ops import post_scores
from hibag_tpu_torch.ops import train_step as ts

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _problem(seed, H, A, N, C=3, n_sel=8, live=600):
    """A classifier of H slots (the first `live` with frequencies, the rest
    empty as in a trainer's padded list) over A alleles; N typed samples
    carrying two of the first 20 haplotypes, a few codes missing; C
    candidates, their frequencies dropped at random but never on those 20."""
    rng = np.random.default_rng(seed)
    L = 128
    bits = np.zeros((H, L), np.float32)
    bits[:, :n_sel] = rng.integers(0, 2, (H, n_sel))
    live = min(live, H)
    freq = np.zeros(H, np.float32)
    freq[:live] = rng.random(live)
    freq /= freq.sum()
    allele = rng.integers(0, A, H).astype(np.int32)
    allele[:20] = rng.permutation(A)[:20] if A >= 20 else allele[:20]
    pair = rng.integers(0, 20, (2, N))
    geno = np.full((N, L), 3, np.int8)
    geno[:, :n_sel] = bits[pair[0], :n_sel] + bits[pair[1], :n_sel]
    geno[:, :n_sel][rng.random((N, n_sel)) < 0.05] = 3
    a12 = np.sort(allele[pair], 0).astype(np.int32)
    B = rng.multinomial(N, np.ones(N) / N).astype(np.float32)
    g_cand = rng.integers(0, 4, (C, N)).astype(np.int8)
    valid = (freq > 0)[None]
    fA = (np.abs(rng.normal(0, .1, (C, H))) * valid).astype(np.float32)
    fB = (np.abs(rng.normal(0, .1, (C, H))) * valid).astype(np.float32)
    drop = rng.random((2, C, H)) < 0.3
    drop[..., :20] = False
    return dict(bits=bits, freq=freq, allele=allele, geno=geno, a1=a12[0],
                a2=a12[1], B=B, g_cand=g_cand, fA=fA, fB=fB,
                fAe=np.where(drop[0], 0, fA).astype(np.float32),
                fBe=np.where(drop[1], 0, fB).astype(np.float32), A=A)


def _t(x, k=True):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t[None] if k else t


@pytest.mark.parametrize("H,A,S", [(4160, 14, 2), (256, 130, 24)])
def test_plain_em_step_past_the_old_limits(H, A, S):
    """The EM step's plain version (models/em.py::em_estep_ref, the
    kernel's signature) at 4,160 slots and at 130 alleles, against
    hibag_tpu's masked jnp E-step: rtol 1e-4 (tests/test_step_pallas.py),
    no kernel launched."""
    p = _problem(1, H, A, S)
    args = (jnp.asarray(p["bits"]), jnp.asarray(p["freq"] > 0),
            jnp.asarray(p["allele"]), jnp.asarray(p["geno"]),
            jnp.asarray(p["a1"]), jnp.asarray(p["a2"]))
    mask = ref.match_pairs(*args)
    assert int(np.asarray(mask).sum()) > 0
    m = ref._geno_sel_masks(jnp.asarray(p["g_cand"]), jnp.float32)
    want = ref._em_estep_masked(jnp.asarray(p["fA"]), jnp.asarray(p["fB"]),
                                mask, jnp.asarray(p["B"]), m, float(S))
    before = dict(ts.LAUNCHES)
    got = em.em_estep_ref(_t(p["fA"]), _t(p["fB"]),
                          _t(np.asarray(mask).astype(np.int8)),
                          _t(p["g_cand"]), _t(p["B"]), float(S))
    assert ts.LAUNCHES == before
    for x, y in zip(got, want):
        np.testing.assert_allclose(x[0].numpy(), np.asarray(y), rtol=1e-4,
                                   atol=1e-9)


@pytest.mark.parametrize("H,A,N", [(4160, 14, 2), (256, 130, 40),
                                   (128, 320, 40)])
def test_plain_evaluation_past_the_old_limits(H, A, N):
    """The candidate evaluation's plain version (models/em.py::
    evaluate_candidates, the kernel's signature) at 4,160 slots and at 130
    and 320 alleles, against hibag_tpu's jnp evaluate_candidates: counts
    exact, -2logLik at rtol 1e-4."""
    p = _problem(2, H, A, N)
    is_oob = np.zeros(N, bool)
    is_oob[::2] = True
    B = np.where(is_oob, 0, p["B"] + 1).astype(np.float32)
    acc_r, ll_r = ref.evaluate_candidates(
        jnp.asarray(p["bits"]), jnp.asarray(p["allele"]), jnp.asarray(16),
        jnp.asarray(p["fAe"]), jnp.asarray(p["fBe"]),
        jnp.asarray(p["g_cand"]), jnp.asarray(p["geno"]),
        jnp.asarray(p["a1"]), jnp.asarray(p["a2"]), jnp.asarray(is_oob),
        jnp.asarray(B), A)
    before = dict(ts.LAUNCHES)
    acc, ll = em.evaluate_candidates(
        _t(p["bits"]), _t(p["allele"]), _t(p["fAe"]), _t(p["fBe"]),
        _t(p["g_cand"]), _t(p["geno"]), _t(p["a1"], False),
        _t(p["a2"], False), _t(is_oob), _t(B), A)
    assert ts.LAUNCHES == before
    assert int(np.asarray(acc_r).sum()) > 0
    np.testing.assert_array_equal(acc[0].numpy(), np.asarray(acc_r))
    np.testing.assert_allclose(ll[0].numpy(), np.asarray(ll_r), rtol=1e-4)


def test_plain_evaluation_detail():
    """detail=True adds, per sample and candidate, the total and true-pair
    score before the FLT_MIN rule and the two best allele cells (value and
    packed upper-triangle index), and leaves the counts and -2logLik as
    they are; the best cell's alleles give the counts."""
    p = _problem(3, 256, 9, 30)
    is_oob = np.ones(30, bool)
    args = (_t(p["bits"]), _t(p["allele"]), _t(p["fAe"]), _t(p["fBe"]),
            _t(p["g_cand"]), _t(p["geno"]), _t(p["a1"], False),
            _t(p["a2"], False), _t(is_oob), _t(p["B"]), 9)
    acc, ll = em.evaluate_candidates(*args)
    acc2, ll2, det = em.evaluate_candidates(*args, detail=True)
    assert torch.equal(acc, acc2) and torch.equal(ll, ll2)
    assert det.shape == (1, 3, 30, 6)
    total, tq, bv, bk, sv, sk = det[0].unbind(-1)
    assert bool((tq <= total * (1 + 1e-6)).all())
    assert bool((sv <= bv).all()) and bool((bk != sk).all())
    # packed index k of cell (g1, g2) back to its alleles
    A = 9
    starts = np.array([g * A - g * (g - 1) // 2 for g in range(A)])
    g1 = np.searchsorted(starts, bk.numpy().astype(int), side="right") - 1
    g2 = g1 + bk.numpy().astype(int) - starts[g1]
    t1, t2 = p["a1"][None], p["a2"][None]
    m1 = (g1 == t1) | (g1 == t2)
    t1u = np.where(m1 & (g1 == t1), -1, t1)
    t2u = np.where(m1 & (g1 != t1) & (g1 == t2), -1, t2)
    cnt = m1.astype(int) + ((g2 == t1u) | (g2 == t2u)).astype(int)
    ok = total.numpy() >= np.finfo(np.float32).tiny
    np.testing.assert_array_equal(acc[0].numpy(), (cnt * ok).sum(1))


def test_wide_steps_per_sample_counts():
    """utils/wide_steps.py's per-sample counts (one evaluation over copies
    of the classifier, copy i counting only sample i) sum to the batch's
    count and equal, sample by sample, the count of the plain version's
    best cell (its detail); on the CPU both run the plain version."""
    from hibag_tpu_torch.utils import wide_steps

    p = _problem(5, 256, 9, 30)
    is_oob = np.zeros(30, bool)
    is_oob[1::2] = True
    args = (_t(p["bits"]), _t(p["allele"]), _t(p["fAe"]), _t(p["fBe"]),
            _t(p["g_cand"]), _t(p["geno"]), _t(p["a1"], False),
            _t(p["a2"], False), _t(is_oob), _t(p["B"]), 9)
    acc, _ = em.evaluate_candidates(*args)
    det = em.evaluate_candidates(*args, detail=True)[2][0]
    assert int(acc.sum()) > 0
    for c in range(3):
        got = wide_steps.kernel_counts(args, 0, c)
        assert int(got.sum()) == int(acc[0, c])
        (best, _, _), _ = wide_steps._cells(det[c], args[6], args[7],
                                            args[8][0], 9)
        assert torch.equal(got, best.to(got.dtype))
        assert int(got[~args[8][0]].abs().sum()) == 0


@pytest.mark.parametrize("H", [4160, 10016])
@pytest.mark.parametrize("A", [130, 320])
def test_eval_and_em_plans_at_wide_shapes(H, A):
    """The evaluation kernel's plan and scratch and the packed EM kernel's
    plan at 4,160 and 10,016 slots and 130 and 320 alleles, from the
    kernels' layouts by their terms: the tiled path always, with no device
    scratch (plan 0), the slot records in device memory past about 9,000
    slots (plan -1, 24 bytes a slot); the packed EM's frequencies and
    accumulator in device memory at C=17."""
    from test_torch_train_step import _eval_smem

    M, plan, _ = ts.eval_plan(H, A, 17, 2, 64, _eval_smem)
    want = ts.EVAL_PLAN_TILED if H == 4160 else ts.EVAL_PLAN_RECORDS
    assert (M, plan) == (H, want)
    assert ts.eval_scratch_bytes(M, plan) == (
        24 * H if plan == ts.EVAL_PLAN_RECORDS else 0)

    def em_smem(H, C, lcap, shared):  # csrc/em_estep.cu PkLayout's terms
        return (shared * 16 * C * H + 388 * C + 2 * H + 36 * (H // 32)
                + 84 + 48 * lcap)
    assert ts.em_packed_plan(H, 17, 1000, em_smem) == (63, 16, False)


@pytest.mark.parametrize("H,A,C,N,route", [
    (4160, 130, 8, 1024, (True, 1024, 0)),
    (4160, 320, 8, 1024, (True, 1024, 0)),
    (10016, 130, 8, 1024, (False, 139, 8 * 139 * 240384)),
    (10016, 320, 1, 4, (False, 4, 4 * 240384)),
    (46340, 160, 8, 1024, (False, 30, 8 * 30 * 1112160))])
def test_scores_plan_at_wide_shapes(H, A, C, N, route):
    """The scoring kernel's route: the slot records (24 bytes a slot) in
    shared memory while they fit, else in a device scratch of RECORD_BYTES
    at most, blocks taking several samples each; the scratch bytes are
    C x blocks x record_bytes(H)."""
    def smem(H, A, records):          # csrc/post_scores.cu smem_bytes
        return (24 * H * records + 4096 + 4 * (A + 1)
                + (A * (A + 1) if A <= 180 else 0))
    assert post_scores.record_bytes(H) == 16 * (H + -(-H // 2))
    assert post_scores.scores_plan(H, A, C, N, smem) == route
    shared, NB, nbytes = route
    assert shared or nbytes <= max(post_scores.RECORD_BYTES,
                                   C * post_scores.record_bytes(H))


def test_wrappers_raise_past_the_real_limits():
    """Past the kernels' real limits (16-bit slot indices in the EM lists,
    the int32 slot-pair triangle of the evaluation and the scoring kernel,
    the scoring kernel's allele count) each wrapper raises ValueError before
    touching a device."""
    fA = torch.rand(1, 2, ts.EM_MAX_H + 32)
    with pytest.raises(ValueError, match="EM_MAX_H"):
        ts.em_estep(fA, fA, torch.zeros(1, 1, 32, 32, dtype=torch.int8),
                    torch.zeros(1, 2, 1, dtype=torch.int8), torch.ones(1, 1),
                    1.0)
    # the kernels form m (m + 1) and i m for slot counts m in int32
    assert ts.EVAL_MAX_H * (ts.EVAL_MAX_H + 1) < 2 ** 31
    assert (ts.EVAL_MAX_H + 1) * (ts.EVAL_MAX_H + 2) >= 2 ** 31
    assert post_scores.MAX_H == ts.EVAL_MAX_H
    assert ts.EVAL_MAX_A == post_scores.MAX_A
    with pytest.raises(ValueError, match="MAX_H"):
        post_scores.check_limits(post_scores.MAX_H + 1, 14)
    with pytest.raises(ValueError, match="MAX_A"):
        post_scores.check_limits(10016, post_scores.MAX_A + 1)
