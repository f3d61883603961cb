"""The CUDA ensemble kernel against its plain PyTorch version, on a card.

Imports neither jax nor hibag_tpu, so that on a machine with a card and no
jax it runs as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Without a card every test here skips.
"""

import os

import numpy as np
import pytest
import torch

from hibag_tpu_torch.ops import ens_acc


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
    torch.cuda.synchronize()
    assert ens_acc.LAUNCHES == before + 1
    ens_r, dmin_r, total_r = ens_acc.ensemble_accumulate_ref(hap, g, wgt, A,
                                                             majority)
    assert torch.equal(dmin, dmin_r)
    torch.testing.assert_close(total, total_r, rtol=3e-4, atol=0)
    torch.testing.assert_close(ens, ens_r, rtol=3e-4, atol=1e-7)
    if majority:
        assert ens[3, 0, 2] == 1 and ens[3, 1, 2] == 0


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
