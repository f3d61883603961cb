"""hibag_tpu_torch.ops.ens_acc (the ensemble kernel's module) held against
hibag_tpu's Pallas kernel, ensemble_accumulate_pallas, run in interpret mode
on the same seeded inputs. On the CPU the wrapper runs the plain version;
the CUDA kernel itself is held against it by tests/test_torch_gpu.py and by
chip_smoke.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hibag_tpu.ops.scoring_pallas import ensemble_accumulate_pallas
from hibag_tpu_torch.models.convert import ensemble_from_jax_prepared
from hibag_tpu_torch.ops import ens_acc

torch.set_num_threads(2)

L, AC = 128, 128


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _inputs(seed, C, H, N, A, tie=False, pattern=None, dominant=False):
    """hibag_tpu's prepared layout (hb, W, valid) plus codes and weights,
    with padded slots, all-missing samples (0, 1) and a zero-weight sample
    (2). `tie` forces an exact tie in classifier 0 for sample 3: alleles 0,
    1 and 2 hold one haplotype each, 0 and 1 identical with equal frequency,
    and the sample is haplotypes 0 + 2, so Q[0,2] == Q[1,2] is its best.
    `pattern` places the heterozygous codes (chip_smoke.het_codes);
    `dominant` gives one allele most haplotypes (chip_smoke.
    dominant_alleles)."""
    rng = np.random.default_rng(seed)
    hb = (rng.random((C, H, L)) < 0.5).astype(np.float32)
    freq = rng.dirichlet(np.ones(H), C).astype(np.float32)
    freq[:, H - H // 8:] = 0.0
    lo = 3 if tie else 0
    allele = (chip_smoke.dominant_alleles(rng, C, H, A, lo) if dominant
              else np.sort(rng.integers(lo, A, (C, H)), axis=1))
    g = chip_smoke.het_codes(rng, pattern, (C, N, L))
    g[:, :2] = 3
    if tie:
        allele[0, :3] = [0, 1, 2]
        hb[0, 1] = hb[0, 0]
        freq[0, 1] = freq[0, 0]
        g[0, 3] = hb[0, 0] + hb[0, 2]
    W = np.zeros((C, H, AC), np.float32)
    for c in range(C):
        W[c, np.arange(H), allele[c]] = freq[c]
    valid = (freq > 0).astype(np.float32)[..., None]
    wgt = rng.random((C, N)).astype(np.float32)
    wgt[:, 2] = 0.0
    return hb, W, valid, g, wgt


def _both(seed, C, H, N, A, majority, tie=False, pattern=None,
          dominant=False):
    hb, W, valid, g, wgt = _inputs(seed, C, H, N, A, tie, pattern, dominant)
    ens_j, dmin_j, total_j = ensemble_accumulate_pallas(
        jnp.asarray(hb), jnp.asarray(W), jnp.asarray(valid), jnp.asarray(g),
        jnp.asarray(wgt[..., None]), (A + 7) // 8 * 8, nb=8, interpret=True,
        majority=majority)
    hap = ensemble_from_jax_prepared(hb, W, valid, "cpu")
    before = ens_acc.LAUNCHES
    ens, dmin, total = ens_acc.ensemble_accumulate(
        hap, torch.from_numpy(g), torch.from_numpy(wgt), A, majority)
    assert ens_acc.LAUNCHES == before  # the CPU path launches no kernel
    return ((np.asarray(ens_j)[:, :A, :A], np.asarray(dmin_j),
             np.asarray(total_j)), (ens.numpy(), dmin.numpy(), total.numpy()))


@pytest.mark.parametrize("seed,C,H,A,majority,tie", [
    (0, 3, 64, 9, False, False),
    (1, 2, 128, 14, False, False),
    (2, 3, 64, 14, True, False),
    (3, 2, 64, 9, True, True),
])
def test_matches_pallas_kernel(seed, C, H, A, majority, tie):
    (ens_j, dmin_j, total_j), (ens, dmin, total) = _both(
        seed, C, H, 16, A, majority, tie)
    np.testing.assert_array_equal(dmin, dmin_j)
    np.testing.assert_allclose(total, total_j, rtol=3e-4)
    np.testing.assert_allclose(ens, ens_j, rtol=3e-4, atol=1e-7)
    assert np.all(ens[2] == ens[2].T)
    if majority:
        # one vote per classifier with weight > 0, at both mirrors
        assert np.all(ens == np.round(ens))
    if tie:
        # the first row-major maximum wins: pair (0, 2), not (1, 2); the
        # other classifier holds only alleles >= 3
        assert ens[3, 0, 2] == 1 and ens[3, 1, 2] == 0


@pytest.mark.parametrize("pattern,dominant,majority", [
    ("all4", False, False), ("none", False, True), ("word3", False, False),
    (None, True, False), ("word3", True, True)])
def test_het_patterns_and_dominant_allele(pattern, dominant, majority):
    """The cases the kernel's distance and cell walk branch on: the sample's
    heterozygous codes in all four 32-SNP words, in none, only in word 3;
    and a classifier whose first allele holds most haplotypes."""
    (ens_j, dmin_j, total_j), (ens, dmin, total) = _both(
        7, 2, 128, 16, 14, majority, True, pattern, dominant)
    np.testing.assert_array_equal(dmin, dmin_j)
    np.testing.assert_allclose(total, total_j, rtol=3e-4)
    np.testing.assert_allclose(ens, ens_j, rtol=3e-4, atol=1e-7)
    if majority:
        assert ens[3, 0, 2] == 1 and ens[3, 1, 2] == 0


def test_pack_compacts_valid_slots_by_allele():
    hb, W, valid, _, _ = _inputs(4, 2, 64, 4, 9)
    hap = ensemble_from_jax_prepared(hb, W, valid, "cpu")
    nh = hap.nh.numpy()
    np.testing.assert_array_equal(nh, valid[..., 0].sum(1))
    assert hap.n_slots == nh.max()
    for c in range(2):
        al = hap.allele[c, :nh[c]].numpy()
        assert np.all(np.diff(al) >= 0)
        assert np.all(hap.freq[c, :nh[c]].numpy() > 0)
        assert np.all(hap.freq[c, nh[c]:].numpy() == 0)
    # bits survive the packing into 32-bit words
    bits = ens_acc.unpack_bits(hap.hb).numpy()
    row = hb[0][valid[0, :, 0] > 0][np.argsort(
        W[0].argmax(-1)[valid[0, :, 0] > 0], kind="stable")]
    np.testing.assert_array_equal(bits[0, :nh[0]], row)


def test_limits_raise():
    """Packing checks its own input only (the layout is shared with the
    scoring kernel); the ensemble kernel's wrapper raises beyond its
    limits."""
    rng = np.random.default_rng(5)
    big = ens_acc.MAX_H + 1
    hap = ens_acc.pack_haplotypes(rng.integers(0, 2, (1, big, L)),
                                  np.full((1, big), 1.0 / big),
                                  np.zeros((1, big), int), 4, "cpu")
    assert hap.n_slots == big
    g = torch.full((1, 2, L), 3, dtype=torch.int8)
    w = torch.ones((1, 2))
    with pytest.raises(ValueError, match="MAX_H"):
        ens_acc.ensemble_accumulate(hap, g, w, 4)
    wide = ens_acc.MAX_A + 1
    hap = ens_acc.pack_haplotypes(rng.integers(0, 2, (1, 8, L)),
                                  np.full((1, 8), 0.125),
                                  np.full((1, 8), wide - 1), wide, "cpu")
    with pytest.raises(ValueError, match="MAX_A"):
        ens_acc.ensemble_accumulate(hap, g, w, wide)
    with pytest.raises(ValueError, match="allele index"):
        ens_acc.pack_haplotypes(rng.integers(0, 2, (1, 8, L)),
                                np.full((1, 8), 0.125), np.full((1, 8), 4),
                                4, "cpu")
    hb, W, valid, g, wgt = _inputs(6, 2, 64, 8, 9)
    hap = ensemble_from_jax_prepared(hb, W, valid, "cpu")
    with pytest.raises(ValueError, match="int8"):
        ens_acc.ensemble_accumulate(hap, torch.from_numpy(g).int(),
                                    torch.from_numpy(wgt), 9)
