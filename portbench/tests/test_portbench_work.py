"""The work counts behind rooflines and MFU shares, on hand-worked cases."""

import numpy as np
import pytest
import torch

from portbench.work import bounds, peaks


def test_pairs():
    assert bounds.pairs([1, 2, 3]).tolist() == [1.0, 3.0, 6.0]


def test_het_words():
    # 2 samples, 70 SNPs; classifier 0 has slots on SNPs 0, 1 and 40 (word 0
    # holds slots 0-31, so all three sit in word 0), classifier 1 has 40
    # slots on SNPs 0..39 (slots 32..39 in word 1)
    codes = torch.zeros((2, 70), dtype=torch.uint8)
    codes[0, 40] = 1                   # het at classifier 0's slot 2
    codes[1, 35] = 1                   # het at classifier 1's slot 35
    codes[1, 0] = 1                    # het at both classifiers' slot 0
    si = torch.full((2, 128), -1, dtype=torch.int64)
    si[0, :3] = torch.tensor([0, 1, 40])
    si[1, :40] = torch.arange(40)
    hw = bounds.het_words(codes, si)
    assert hw.tolist() == [[1.0, 1.0], [0.0, 2.0]]


def test_scoring_work():
    nh = np.array([2, 3])
    hw = np.array([[1.0, 0.0], [2.0, 1.0]])
    w = bounds.scoring_work(nh, hw, n_alleles=4, ensemble=True)
    # pairs 3 and 6; popcounts 3*1 + 6*(2+1) = 21; flops 2 * N(2) * 9 = 36
    assert w["popc"] == 21.0 and w["flops"] == 36.0
    # haplotypes 24 * 5 + 4 * 2, codes 2*2*128, dmin/total 8*4, weights
    # 4*4, ensemble 4*2*16
    assert w["bytes"] == 128 + 512 + 32 + 16 + 128
    s = bounds.scoring_work(nh, hw, n_alleles=4, ensemble=False)
    assert s["bytes"] == 128 + 512 + 32 + 4 * 2 * 2 * 16
    c = bounds.predict_call_work(nh, hw, n_alleles=4, n_snp=10)
    assert c["bytes"] == w["bytes"] + 2 * 10 + 4 * 2 * 9


def test_train_popc():
    # haplotypes (allele, bits): (0, 01), (0, 11), (1, 01); mtry 2, 3
    # samples. Step 1: projections (0,0), (0,1), (1,0): 3 distinct, 6
    # pairs, 2 x 6 x 3 x 1 word = 36. Step 2: 3 distinct, 36 again.
    allele = np.array([0, 0, 1])
    bits = np.array([[0, 1], [1, 1], [0, 1]])
    assert bounds.train_popc([(allele, bits)], mtry=2, n_samples=3) == 72.0
    # 33 SNPs of one haplotype: steps 1..32 one word, step 33 two
    one = (np.array([0]), np.zeros((1, 33), dtype=np.uint8))
    assert bounds.train_popc([one], mtry=1, n_samples=1) == 32 + 2


def test_least_seconds():
    t = peaks.least_seconds(3.35e12, 0.0, 0.0, 1e12)
    assert t == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 2e12, 0.0, 1e12) == pytest.approx(2.0)
    assert peaks.least_seconds(0.0, 0.0, 67e12, 1e12) == pytest.approx(1.0)
