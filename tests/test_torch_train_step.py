"""The training-step kernels' plain versions (models/em.py's em_estep_ref,
em_estep_packed_ref and evaluate_candidates, under the signatures of
hibag_tpu_torch.ops.train_step's wrappers) held against hibag_tpu's TPU
kernels run in Pallas interpret mode, as tests/test_step_pallas.py runs
them, and the wrappers' checks. The CUDA kernels themselves run only on a
card (tests/test_torch_gpu.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibag_tpu.models.em import _geno_sel_masks, match_pairs, \
    match_pairs_packed
from hibag_tpu.ops import train_step_pallas as tpu
from hibag_tpu_torch.models import em
from hibag_tpu_torch.ops import _build
from hibag_tpu_torch.ops import train_step as ts

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _rand_problem(seed=0, N=24, H=128, L=128, Cm=9, A=6):
    """tests/test_step_pallas.py::_rand_problem."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (H, L)).astype(np.float32)
    freq = rng.random(H).astype(np.float32)
    freq[40:] = 0
    freq /= freq.sum()
    allele = np.sort(rng.integers(0, A, H)).astype(np.int32)
    geno_sel = rng.integers(0, 4, (N, L)).astype(np.int8)
    a12 = np.sort(rng.integers(0, A, (2, N)), 0).astype(np.int32)
    B = rng.multinomial(N, np.ones(N) / N).astype(np.float32)
    g_cand = rng.integers(0, 4, (Cm, N)).astype(np.int8)
    fA = (np.abs(rng.normal(0, .1, (Cm, H))) * (freq > 0)).astype(np.float32)
    fB = (np.abs(rng.normal(0, .1, (Cm, H))) * (freq > 0)).astype(np.float32)
    return bits, freq, allele, geno_sel, a12, B, g_cand, fA, fB, A


def _t(x):
    """numpy -> torch with a leading classifier axis of 1."""
    return torch.from_numpy(np.ascontiguousarray(x))[None]


def _masks(bits, freq, allele, geno_sel, a12):
    args = (jnp.asarray(bits), jnp.asarray(freq > 0), jnp.asarray(allele),
            jnp.asarray(geno_sel), jnp.asarray(a12[0]), jnp.asarray(a12[1]))
    return match_pairs(*args), match_pairs_packed(*args)


@pytest.mark.parametrize("N", [24, 80])
def test_em_estep_plain_matches_em_kernel(N):
    # N=80 pads to two of the TPU kernel's sample chunks
    bits, freq, allele, geno_sel, a12, B, g_cand, fA, fB, A = \
        _rand_problem(N=N)
    Cm = fA.shape[0]
    mask, _ = _masks(bits, freq, allele, geno_sel, a12)
    m = _geno_sel_masks(jnp.asarray(g_cand), jnp.float32)
    Bj = jnp.asarray(B)
    maskT, m3, B2, cp = tpu.em_prepare_pallas(mask, m, Bj, Cm)
    fa_p, fb_p = tpu.em_pad_candidates(jnp.asarray(fA), jnp.asarray(fB), cp)
    want = tpu.em_estep_pallas(fa_p, fb_p, maskT, m3, B2, 24.0,
                               interpret=True)
    before = dict(ts.LAUNCHES)
    got = em.em_estep_ref(_t(fA), _t(fB),
                          _t(np.asarray(mask).astype(np.int8)), _t(g_cand),
                          _t(B), 24.0)
    assert ts.LAUNCHES == before   # the plain version launches nothing
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0][:Cm]),
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1][:Cm]),
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(want[2][:Cm, 0]),
                               rtol=1e-4)


def test_em_estep_packed_plain_matches_packed_kernel():
    bits, freq, allele, geno_sel, a12, B, g_cand, fA, fB, A = \
        _rand_problem(seed=4)
    Cm, H = fA.shape
    _, packed = _masks(bits, freq, allele, geno_sel, a12)
    m = _geno_sel_masks(jnp.asarray(g_cand), jnp.float32)
    packedT, m3, B2, cp = tpu.em_prepare_packed_pallas(
        packed, m, jnp.asarray(B), Cm, H)
    fa_p, fb_p = tpu.em_pad_candidates(jnp.asarray(fA), jnp.asarray(fB), cp)
    want = tpu.em_estep_pallas_packed(fa_p, fb_p, packedT, m3, B2, 24.0,
                                      interpret=True)
    got = em.em_estep_packed_ref(_t(fA), _t(fB), _t(np.asarray(packed)),
                                 _t(g_cand), _t(B), 24.0)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0][:Cm]),
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1][:Cm]),
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(want[2][:Cm, 0]),
                               rtol=1e-4)


@pytest.mark.parametrize("seed,N,H,drop", [(1, 24, 128, 0.3),
                                           (7, 16, 640, 0.0)])
def test_evaluate_plain_matches_eval_kernel(seed, N, H, drop):
    """The cases of tests/test_step_pallas.py (test_eval_kernel_matches_jnp
    and test_eval_kernel_h640)."""
    rng = np.random.default_rng(seed)
    bits, freq, allele, geno_sel, a12, B, g_cand, fA, fB, A = \
        _rand_problem(seed=seed, N=N, H=H)
    fA = np.where(rng.random(fA.shape) < drop, 0, fA).astype(np.float32)
    fB = np.where(rng.random(fB.shape) < drop, 0, fB).astype(np.float32)
    is_oob = B == 0
    acc_p, ll_p = tpu.evaluate_candidates_pallas(
        jnp.asarray(bits), jnp.asarray(allele), jnp.asarray(fA),
        jnp.asarray(fB), jnp.asarray(g_cand), jnp.asarray(geno_sel),
        jnp.asarray(a12[0]), jnp.asarray(a12[1]), jnp.asarray(is_oob),
        jnp.asarray(B), A, interpret=True)
    before = dict(ts.LAUNCHES)
    acc, ll = em.evaluate_candidates(
        _t(bits), _t(allele), _t(fA), _t(fB), _t(g_cand), _t(geno_sel),
        torch.from_numpy(a12[0].copy()), torch.from_numpy(a12[1].copy()),
        _t(is_oob), _t(B), A)
    assert ts.LAUNCHES == before
    np.testing.assert_array_equal(acc[0].numpy(), np.asarray(acc_p))
    np.testing.assert_allclose(ll[0].numpy(), np.asarray(ll_p), rtol=1e-4)


def test_pen_table_is_the_plain_penalty():
    from hibag_tpu_torch.constants import LOG_MIN_RARE_FREQ
    tab = _build.pen_table(torch.device("cpu"))
    d = torch.arange(257, dtype=torch.float32)
    assert torch.equal(tab, torch.exp(LOG_MIN_RARE_FREQ * d))
    assert tab[0] == 1 and tab[256] == 0


def test_eval_layout_keeps_each_alleles_slots():
    """eval_layout is a permutation of the slots that puts the ok ones
    first, sorted by allele, each with its bits and its candidates' fA and
    fB; the frequency groups are 0 past C."""
    rng = np.random.default_rng(8)
    K, C, H, A = 2, 6, 40, 5
    bits = rng.integers(0, 2, (K, H, 128)).astype(np.float32)
    allele = rng.integers(0, A, (K, H)).astype(np.int32)
    fA = rng.random((K, C, H)).astype(np.float32)
    fB = rng.random((K, C, H)).astype(np.float32)
    fA[rng.random(fA.shape) < 0.5] = 0
    dead = rng.random((K, H)) < 0.3
    fA[:, :, :] *= ~dead[:, None]
    fB[:, :, :] *= ~dead[:, None]
    hb, al, fq, nok = ts.eval_layout(
        torch.from_numpy(bits), torch.from_numpy(allele),
        torch.from_numpy(fA), torch.from_numpy(fB), A)
    assert hb.shape == (K, H, 4) and fq.shape == (K, H, 2, 2, 4)
    assert fq[:, :, 1, :, 2:].abs().sum() == 0          # candidates 6, 7
    words = ts.pack_bits(torch.from_numpy(bits))
    for k in range(K):
        m = int(nok[k])
        assert m == int((~dead[k]).sum())
        assert bool((al[k, :m] < A).all()) and bool((al[k, m:] == A).all())
        assert bool((al[k, 1:m] >= al[k, :m - 1]).all())
        f = fq[k].permute(0, 2, 1, 3).reshape(H, 2, 8)[..., :C]
        for a in range(A):
            want = sorted(
                (tuple(words[k, i].tolist()), tuple(fA[k, :, i].tolist()),
                 tuple(fB[k, :, i].tolist()))
                for i in range(H) if allele[k, i] == a and not dead[k, i])
            got = sorted(
                (tuple(hb[k, i].tolist()), tuple(f[i, 0].tolist()),
                 tuple(f[i, 1].tolist()))
                for i in range(m) if al[k, i] == a)
            assert got == want


def _eval_smem(M, A, C, plan):
    """The evaluation kernel's shared memory (csrc/eval_cand.cu Layout), by
    its terms: table and penalties, allele offsets, the slot records (plans
    1 and 0); the phase path's frequencies, row scratch and cell grids (plan
    1); the tiled path's (plans 0 and -1) tile of cells (slot ranges,
    [candidate][cell] values; 24 KB of values, in multiples of 32 cells up
    to 1,024), the lanes' finish state and each warp's T of 32 rows."""
    Cp = -(-C // 4) * 4
    T = min(1024, 24576 // (4 * Cp) // 32 * 32)
    tiled = 16 * T + 4 * Cp * T + 16 * Cp * 32 + 4 * 8 * 32 * Cp
    return (1040 + 12 * Cp + 16 * ((A + 4) // 4) + 24 * M * (plan >= 0)
            + ((plan == 1) * 4 * Cp * (3 * M + A * (A + 1) // 2)
               or tiled))


def test_eval_plan_prefers_shared_memory():
    """eval_plan takes the phase path in shared memory where its
    frequencies, scratch and grids fit the budget, else the tiled path with
    the slot records in shared memory and no device scratch, the records in
    device memory where they do not fit (their scratch capped), and raises
    when not even that fits."""
    smem = _eval_smem
    assert ts.eval_plan(256, 14, 17, 8, 1024, smem) == (256, True, 8)
    assert ts.eval_plan(254, 14, 17, 25, 64, smem) == (256, True, 2)
    assert ts.eval_plan(1024, 14, 17, 8, 1024, smem) == (1024, False, 8)
    assert ts.eval_plan(256, 14, 17, 8, 1024, smem,
                        smem(256, 14, 17, 0)) == (256, False, 8)
    # 8 classifiers of 4,096 slots and 128 alleles: the tiled path, no
    # device scratch, so 128 runs of 8 samples
    assert ts.eval_scratch_bytes(4096, ts.EVAL_PLAN_TILED) == 0
    M, plan, S = ts.eval_plan(4096, 128, 61, 8, 1024, smem)
    assert (M, plan, S) == (4096, ts.EVAL_PLAN_TILED, 8)
    assert ts.eval_plan(10000, 14, 17, 1, 1, smem) == (
        10000, ts.EVAL_PLAN_RECORDS, 1)
    with pytest.raises(ValueError, match="shared memory"):
        ts.eval_plan(64, 60000, 64, 1, 1, smem)


@pytest.mark.parametrize("H,A,plan,per", [
    (4160, 130, 0, 0),
    (4160, 320, 0, 0),
    (10016, 130, -1, 24 * 10016),
    (10016, 320, -1, 24 * 10016),
    (64, 130, 0, 0),
    (512, 320, 0, 0)])
def test_eval_plan_past_the_old_limits(H, A, plan, per):
    """Past 4,096 slots or 128 alleles the cell grids leave shared memory
    for the tiled path (plan 0), with no device scratch; past about 9,000
    slots the slot records go to device memory (plan -1), 24 bytes a slot
    of scratch a block. K=4, C=17 (padded to 20), N=1,024."""
    M, got, S = ts.eval_plan(H, A, 17, 4, 1024, _eval_smem)
    assert (M, got) == (H, plan)
    assert ts.eval_scratch_bytes(M, got) == per
    runs = max(1, ts.EVAL_SCRATCH_BYTES // (4 * per)) if per else 1
    assert S == max(-(-4 * 1024 // (8 * 132)), -(-1024 // runs) if per else 1)
    assert 4 * -(-1024 // S) * per <= ts.EVAL_SCRATCH_BYTES


@pytest.mark.parametrize("H", [1024, 2048])
@pytest.mark.parametrize("A", [153, 160])
def test_eval_plan_at_the_wide_training_cell(H, A):
    """hla_b-train's steps (K=2, C=17, N=1,000, 153 or 160 alleles, 1,024
    or 2,048 slots) take the tiled path with no device scratch, two blocks
    of it to an SM; hla_a's (A=14, H=256, C=17, K=8) the phase path in
    shared memory."""
    M, plan, S = ts.eval_plan(H, A, 17, 2, 1000, _eval_smem)
    assert (M, plan, S) == (H, ts.EVAL_PLAN_TILED, 2)
    assert ts.eval_scratch_bytes(M, plan) == 0
    assert 2 * (_eval_smem(M, A, 17, plan) + 1024) <= 228 * 1024
    assert ts.eval_plan(256, 14, 17, 8, 1000, _eval_smem)[1] \
        == ts.EVAL_PLAN_SHARED


def test_em_packed_plan_depends_on_samples_only():
    """em_packed_plan's runs come from S alone (at least a batch of
    EM_PACKED_WARPS samples a block, at most EM_MAX_GROUPS runs), so a
    classifier's sums do not depend on the batch K; the frequencies and the
    accumulator go to shared memory where they fit the budget, else to
    device memory; it raises when not even the pair lists fit."""
    def smem(H, C, lcap, shared):    # the kernel's layout, by its terms
        return (shared * 16 * C * H + 388 * C + 2 * H + 36 * (H // 32)
                + 84 + 48 * lcap)
    plan = lambda H, C, S, **kw: ts.em_packed_plan(H, C, S, smem, **kw)
    assert ts.EM_PACKED_WARPS == 8 and ts.EM_MAX_GROUPS == 64
    assert plan(256, 17, 1024) == (64, 16, True)      # the slice's step
    assert plan(128, 32, 64) == (8, 8, True)          # the headline step
    assert plan(512, 17, 1000) == (63, 16, True)      # a re-seated one
    assert plan(1024, 17, 1024) == (64, 16, False)
    assert plan(128, 1, 5) == (1, 5, True)
    assert plan(128, 1, 0) == (1, 1, True)
    assert plan(256, 17, 1024, budget=smem(256, 17, 512, 0)) \
        == (64, 16, False)
    for S in (1, 7, 8, 9, 63, 64, 65, 511, 512, 513, 1000, 4099):
        G, R, _ = plan(256, 17, S)
        assert G * R >= S > (G - 1) * R and G <= ts.EM_MAX_GROUPS
        assert R >= min(S, ts.EM_PACKED_WARPS)
    with pytest.raises(ValueError, match="shared memory"):
        plan(4096, 64, 64, pair_list=5000)
    # past 4,096 slots: the frequencies and accumulator in device memory,
    # the row bitmasks and lists sized from H; at 65,536 slots and C=64 the
    # lists no longer fit
    assert plan(4160, 17, 1000) == (63, 16, False)
    assert plan(10016, 64, 8) == (1, 8, False)
    assert plan(10016, 1, 8) == (1, 8, True)     # 160 KB at C=1
    assert smem(10016, 64, 64, 0) == 59288
    with pytest.raises(ValueError, match="shared memory"):
        plan(65536, 64, 8)


def test_pack_bits_layout():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (3, 5, 128)).astype(np.float32)
    words = ts.pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32)
    for w in range(4):
        want = (bits[..., 32 * w:32 * (w + 1)].astype(np.uint64)
                << np.arange(32, dtype=np.uint64)).sum(-1)
        np.testing.assert_array_equal(words[..., w], want)


def _em_args(K=1, C=3, H=64, S=8, packed=False):
    fA = torch.rand(K, C, H)
    mask = (torch.zeros(K, S, H, H // 8, dtype=torch.uint8) if packed
            else torch.zeros(K, S, H, H, dtype=torch.int8))
    return [fA, fA.clone(), mask, torch.zeros(K, C, S, dtype=torch.int8),
            torch.ones(K, S), 8.0]


@pytest.mark.parametrize("packed", [False, True])
def test_em_wrapper_raises_on_what_the_kernel_does_not_take(packed):
    fn = ts.em_estep_packed if packed else ts.em_estep
    plain = "em_estep_packed_ref" if packed else "em_estep_ref"
    with pytest.raises(ValueError, match=f"CUDA tensors only.*{plain}"):
        fn(*_em_args(packed=packed))      # a shape it takes, on the CPU
    with pytest.raises(ValueError, match="MAX_C"):
        fn(*_em_args(C=ts.MAX_C + 1, packed=packed))
    with pytest.raises(ValueError, match="EM_H_MULTIPLE"):
        fn(*_em_args(H=48, packed=packed))
    past = _em_args(H=32, S=1, packed=packed)   # H is checked first
    past[:2] = [torch.rand(1, 3, ts.EM_MAX_H + 32)] * 2
    with pytest.raises(ValueError, match="EM_MAX_H"):
        fn(*past)
    bad = _em_args(packed=packed)
    bad[2] = bad[2].to(torch.int16)
    with pytest.raises(ValueError, match="mask"):
        fn(*bad)
    bad = _em_args(packed=packed)
    bad[4] = bad[4].double()
    with pytest.raises(ValueError, match="B must be"):
        fn(*bad)
    bad = _em_args(packed=packed)
    bad[0] = bad[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fn(*bad)


def _eval_args(K=1, C=3, H=64, N=8, A=6):
    L = 128
    return [torch.zeros(K, H, L), torch.zeros(K, H, dtype=torch.int32),
            torch.rand(K, C, H), torch.rand(K, C, H),
            torch.zeros(K, C, N, dtype=torch.int8),
            torch.full((K, N, L), 3, dtype=torch.int8),
            torch.zeros(N, dtype=torch.int32), torch.zeros(N, dtype=torch.int32),
            torch.zeros(K, N, dtype=torch.bool), torch.ones(K, N), A]


def test_eval_wrapper_raises_on_what_the_kernel_does_not_take():
    with pytest.raises(ValueError,
                       match="CUDA tensors only.*evaluate_candidates"):
        ts.evaluate_candidates_kernel(*_eval_args())   # on the CPU
    with pytest.raises(ValueError, match="MAX_C"):
        ts.evaluate_candidates_kernel(*_eval_args(C=ts.MAX_C + 1))
    with pytest.raises(ValueError, match="EVAL_MAX_A"):
        ts.evaluate_candidates_kernel(*_eval_args(A=ts.EVAL_MAX_A + 1))
    past = _eval_args(H=8, N=1, C=1)            # H is checked first
    past[2:4] = [torch.rand(1, 1, ts.EVAL_MAX_H + 1)] * 2
    with pytest.raises(ValueError, match="EVAL_MAX_H"):
        ts.evaluate_candidates_kernel(*past)
    bad = _eval_args()
    bad[6] = bad[6].long()
    with pytest.raises(ValueError, match="a1 and a2"):
        ts.evaluate_candidates_kernel(*bad)
    bad = _eval_args()
    bad[8] = bad[8].to(torch.uint8)
    with pytest.raises(ValueError, match="is_oob"):
        ts.evaluate_candidates_kernel(*bad)
